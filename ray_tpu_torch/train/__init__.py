"""ray_tpu_torch.train — the train runtime on GPU-leased workers (ref
analog: python/ray/train; architecture per train/v2, SURVEY.md §2.3/§3.4).
The port of ray_tpu/train; importing it imports no torch (the recipes
import it inside their bodies, since workers boot without it)."""

from ray_tpu_torch.train.checkpoint import (  # noqa: F401
    AsyncSave, Checkpoint, CheckpointManager, load_pytree, save_pytree,
    save_pytree_async)
from ray_tpu_torch.train.config import (  # noqa: F401
    CheckpointConfig, FailureConfig, Result, RunConfig, ScalingConfig)
from ray_tpu_torch.train.controller import (  # noqa: F401
    ElasticScalingPolicy, FailurePolicy, ScalingPolicy, TrainController,
    TrainingFailedError)
from ray_tpu_torch.train.ingest import (  # noqa: F401
    CorpusIngestIterator, IngestSpec)
from ray_tpu_torch.train.recipes import (  # noqa: F401
    corpus_pretrain_loop, lora_finetune_loop)
from ray_tpu_torch.train.session import (  # noqa: F401
    get_checkpoint, get_context, get_device, get_ingest, report)
from ray_tpu_torch.train.telemetry import StepRecorder  # noqa: F401
from ray_tpu_torch.train.trainer import (  # noqa: F401
    DataParallelTrainer, TorchTrainer)
