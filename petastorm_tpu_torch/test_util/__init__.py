"""Test harnesses that ship with the package: the data service's chaos plane
(:mod:`~petastorm_tpu_torch.test_util.chaos`)."""
