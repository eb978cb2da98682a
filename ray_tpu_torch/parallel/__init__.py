"""Train-step builders of the port (single device in this slice)."""
