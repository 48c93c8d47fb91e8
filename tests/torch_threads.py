"""Shared set-up of the PyTorch port's CPU tests, imported by each of
their files: torch's intra-op threads capped at one per process.  The
suite runs in several worker processes on a few cores, and torch's
default (one thread per core in every worker) oversubscribes them: a
64x64 flagship train forward and backward took 22.6 s with 8 threads
beside a running suite and 0.48 s with 1."""
import torch

TORCH_THREADS = 1
torch.set_num_threads(TORCH_THREADS)
