"""PyTorch/CUDA port of ct_mapreduce_tpu's ingest paths (the walker lane
and the pre-parsed lane) on one device.

The JAX package (``ct_mapreduce_tpu``) is the reference; this package
imports nothing from it and keeps its module names, so each module's
counterpart is found by path. Entry points run on the CUDA device
unless the caller passes ``device="cpu"``; on the CPU every kernel
wrapper runs its plain PyTorch version.
"""
