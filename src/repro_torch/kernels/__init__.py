"""Hand-written Hopper kernels for the port's compute hot spots.

  gram — G = X^T X and X^T v (the lmDS hot ops), CUDA C++ for sm_90a in
         `repro_torch/csrc/gram.cu`, replacing the Pallas kernels of
         `repro.kernels.gram.kernel`
  spmm — block-sparse XᵀX, X @ W and Xᵀv over a dense layout of a BCOO X
         and a mask of its nonzero blocks (the bcoo lane's hot ops), CUDA
         C++ for sm_90a in `repro_torch/csrc/spmm.cu`, replacing the
         Pallas kernels of `repro.kernels.spmm.kernel`

Each package: ref.py (plain torch version, used for CPU tensors) and
ops.py (dispatch: the CUDA kernel on a CUDA tensor, with a launch
counter). `build` compiles the CUDA sources at first use.
"""
