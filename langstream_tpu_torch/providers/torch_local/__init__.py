"""The ``torch-local`` provider: model, engine and service on one GPU."""
