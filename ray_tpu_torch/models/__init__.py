"""Models of the port: Llama (training half) and weight conversion."""
