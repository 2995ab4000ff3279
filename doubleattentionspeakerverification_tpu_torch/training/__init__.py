"""The train step and its optimizers (JAX ``training/``)."""
