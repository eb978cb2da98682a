"""ray_tpu_torch.tune: hyperparameter search over trial actors (ref
analog: python/ray/tune; SURVEY.md §2.3 Tune). Each trial is a WorkerGroup
of TrainWorkers, leased the GPU its ScalingConfig asks for (one by default;
a fraction such as ``{"GPU": 0.5}`` lets two trials share the card)."""

from ray_tpu_torch.train.checkpoint import Checkpoint  # noqa: F401
from ray_tpu_torch.train.session import (  # noqa: F401
    get_checkpoint, get_context, report)
from ray_tpu_torch.tune.result_grid import ResultGrid  # noqa: F401
from ray_tpu_torch.tune.schedulers import (  # noqa: F401
    ASHAScheduler, FIFOScheduler, PopulationBasedTraining)
from ray_tpu_torch.tune.search import (  # noqa: F401
    choice, grid_search, loguniform, randint, sample_from, uniform)
from ray_tpu_torch.tune.trial import Trial, TrialStatus  # noqa: F401
from ray_tpu_torch.tune.tuner import TuneConfig, Tuner  # noqa: F401
from ray_tpu_torch.tune.tpe import (BOHBSearcher, Searcher,  # noqa: F401,E402
                                    TPESearcher)
