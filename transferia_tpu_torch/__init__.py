"""PyTorch / CUDA port of transferia_tpu's columnar transform path.

The fused mask+filter step (HMAC-SHA256 masking plus a three-valued row
predicate) runs through hand-written CUDA kernels for Hopper (sm_90a)
under ``transform.build_chain(config, device=...).apply(batch)``.  Entry
points run on CUDA unless the caller passes ``device="cpu"``, where each
kernel's plain PyTorch version runs instead.  The package imports
neither JAX nor the JAX package.
"""
