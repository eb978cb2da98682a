"""Models of the port: Llama (with LoRA and MoE), the MLP, and weight
conversion."""
