"""Hand-written Hopper kernels for the port's compute hot spots.

  gram — G = X^T X and X^T v (the lmDS hot ops), CUDA C++ for sm_90a in
         `repro_torch/csrc/gram.cu`, replacing the Pallas kernels of
         `repro.kernels.gram.kernel`
  spmm — block-sparse XᵀX, X @ W and Xᵀv over a dense layout of a BCOO X
         and a mask of its nonzero blocks (the bcoo lane's hot ops), CUDA
         C++ for sm_90a in `repro_torch/csrc/spmm.cu`, replacing the
         Pallas kernels of `repro.kernels.spmm.kernel`
  flash_attention — causal/full GQA attention (dense prefill), CUDA C++
         for sm_90a in `repro_torch/csrc/flash.cu`, replacing
         `repro.kernels.flash_attention.kernel.flash_pallas`
  rwkv6 — the chunked RWKV-6 WKV recurrence (ssm prefill), CUDA C++ for
         sm_90a in `repro_torch/csrc/wkv6.cu`, replacing
         `repro.kernels.rwkv6.kernel.wkv6_pallas`
  ssd  — the Mamba selective scan (hybrid prefill), CUDA C++ for sm_90a
         in `repro_torch/csrc/ssd.cu`, replacing
         `repro.kernels.ssd.kernel.ssm_scan_pallas`

Each package: ref.py (plain torch version or oracle, and the per-entry
error measure the kernel is held to) and ops.py (dispatch: the CUDA
kernel on a CUDA tensor, with a launch counter; the plain version on a
CPU tensor). `build` compiles the CUDA sources at first use.

The model kernels (flash, wkv6, ssd) are forward-only, as their Pallas
counterparts: their CUDA wrappers refuse a call that autograd would
record (`no_backward`) rather than return outputs cut from the graph.
Training takes the plain routes by name (`Model.loss`).
"""
import torch


def no_backward(name: str, *inputs: torch.Tensor) -> None:
    """Raise if grad mode is on and any of `inputs` requires grad: the
    kernel `name` writes into fresh tensors, so its outputs would carry no
    gradient back to them."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward (nor has its Pallas "
            f"kernel in the reference); training takes the plain route "
            f"(Model.loss passes plain=True)")
