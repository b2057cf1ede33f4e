"""repro_torch — the PyTorch/CUDA port of the ``repro`` federated-learning
package, for one NVIDIA H100.

The JAX package ``repro`` is the reference this package is held against;
``repro_torch`` imports ``torch`` and never ``jax`` or anything of ``repro``
(it keeps its own copies of the numpy-only modules it needs). Entry points
run on the card unless the caller passes ``device="cpu"``; the two mixing
kernels (``kernels/fed_mix_sparse.py``, ``kernels/fed_mix.py``) are CUDA C++
written for Hopper, with their plain PyTorch versions in ``kernels/ref.py``
serving CPU tensors.
"""
