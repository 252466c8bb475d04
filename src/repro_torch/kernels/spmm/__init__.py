"""Block-sparse gram / SpMM / xtv (the bcoo lane's kernels)."""
