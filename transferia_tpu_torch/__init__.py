"""PyTorch / CUDA port of transferia_tpu.

The fused mask+filter step (HMAC-SHA256 masking plus a three-valued row
predicate) runs through hand-written CUDA kernels for Hopper (sm_90a)
under ``transform.build_chain(config, device=...).apply(batch)``, as do
the table fingerprint, the mesh and the lambda transformer; the snapshot
transfer (``tasks.SnapshotLoader``) and INCREMENT_ONLY replication
(``runtime.local.run_replication``) drive them through the sink
pipeline.  Entry points run on CUDA unless the caller passes
``device="cpu"``, where each kernel's plain PyTorch version runs
instead.  The package imports neither JAX nor the JAX package.
"""
