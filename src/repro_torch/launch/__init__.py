"""Command-line launchers (port of ``repro.launch``): ``serve`` and
``train``.  The reference's ``dryrun``, ``roofline`` and ``mesh`` (TPU
mesh code) are not ported yet."""
