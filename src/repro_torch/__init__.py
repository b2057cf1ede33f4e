"""repro_torch — the PyTorch/CUDA port of the ``repro`` federated-learning
package, for one NVIDIA H100.

The JAX package ``repro`` is the reference this package is held against;
``repro_torch`` imports ``torch`` and never ``jax`` or anything of ``repro``
(it keeps its own copies of the numpy-only modules it needs). Entry points
run on the card unless the caller passes ``device="cpu"``. The seven kernels
the JAX package wrote in Pallas (the mixing kernels, ``fed_aggregate``, and
the LM stack's ``flash_attention`` and ``ssd_scan``) are CUDA C++ written for
Hopper (``kernels/csrc/``), with their plain PyTorch versions in
``kernels/ref.py`` serving CPU tensors; LM training differentiates the two
LM kernels through hand-written backward kernels (``flash_attention_bwd``,
``ssd_scan_bwd``), where the JAX package differentiates jnp code.
"""
