"""The port's launch scripts (``*.sh``) and its train-scaling harness."""
