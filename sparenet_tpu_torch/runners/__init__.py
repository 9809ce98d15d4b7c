"""Training: the flagship SpareNet step (``runners.sparenet.train_step``)
and the optimizer rules it uses (``runners.base``)."""
