"""Hand-written Hopper kernels of the port, their plain PyTorch versions,
the torch oracles (``ref``) and the model-level folds (``ops``)."""
