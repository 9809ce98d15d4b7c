"""The port's point-cloud ops: each kernel wrapper beside its plain PyTorch
version (``knn``, ``gather``, ``expansion_penalty``, ``mds``)."""
