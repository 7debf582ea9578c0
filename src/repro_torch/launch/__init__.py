"""Launchers (port of ``repro.launch``): the ``serve`` and ``train`` CLIs,
the production meshes (``mesh``), the H100 roofline (``roofline``) and
the meta-device dry run (``dryrun``).  The mesh's collectives inside the
models (ring attention, the flash-decode combine, per-shard MoE
dispatch) are not ported yet."""
