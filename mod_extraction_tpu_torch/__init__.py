"""PyTorch + CUDA port of `mod_extraction_tpu` for NVIDIA Hopper (H100).

The module layout mirrors the JAX package (`ops/`, `models/`, `losses/`,
`train/`, `data/`, `utils/`) so each file has an obvious counterpart.  The
package imports torch and numpy only — never JAX, and nothing of the JAX
package; what it needs from there is copied here.

Entry points run on the card (`device="cuda"`) unless the caller asks for
the CPU, and raise when CUDA is requested but absent.  The hand-written
CUDA kernels (`csrc/`) serve CUDA tensors; their plain PyTorch versions
serve CPU tensors (the tests) and nothing else.
"""
