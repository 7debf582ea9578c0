"""X-STCC on PyTorch and CUDA: the port of ``repro`` to an NVIDIA H100.

Module names follow the JAX package (``repro``) so that every module
here has a counterpart there; the JAX package stays the reference.  The
port imports ``torch`` and never ``jax`` or ``repro``.

Entry points (``storage.simulator.run_protocol`` /
``evaluate_level``, ``engine.replay.EpochEngine``,
``core.replicated_store.ReplicatedStore``, ``serve.ServingEngine``,
``serve.ShardedServingRouter``, ``train.Trainer``, ``sync.SyncEngine``,
``checkpoint.CheckpointStore``) take ``device=`` and default
to ``"cuda"``: they run on the CPU only when asked to
(``device="cpu"``), and raise when no card is present otherwise.  The
hand-written CUDA kernels live in ``csrc/`` and are built with ``nvcc``
at first use (``kernels.build``).
"""
