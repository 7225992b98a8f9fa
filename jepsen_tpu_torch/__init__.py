"""jepsen_tpu_torch: the PyTorch/CUDA port of jepsen_tpu's analysis path.

The JAX package `jepsen_tpu` checks stored histories with JAX kernels on
a TPU; this package runs the same batch checks with PyTorch on an NVIDIA
Hopper GPU (H100), the closure squaring in a CUDA kernel written by hand
for `sm_90a`. It imports neither `jax` nor anything of `jepsen_tpu`:
where it needs a module of the JAX package it keeps its own copy, under
the same name and in the same place, so each module here has an
obvious counterpart there.

The ported slice is the batch Elle list-append sweep:

    cli            python -m jepsen_tpu_torch.cli analyze-store
    store          run-dir walk, verdict journal, results.edn rendering
    ingest         serial history -> EncodedHistory encoding
    parallel       length bucketing, packing, host->device copy
    checker/elle   encoder, edge build, closure, anomaly flags, verdicts
      closure_square + csrc/closure_square.cu   the hand kernel
    _build         compiles csrc/*.cu with nvcc at first use
    devices        the torch.device every entry point runs on

Entry points run on `cuda` unless the caller asks for `cpu`.
"""

__version__ = "0.1.0"
