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
"""
