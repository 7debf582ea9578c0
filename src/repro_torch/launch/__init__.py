"""Command-line launchers (port of ``repro.launch``): ``serve``.  The
reference's ``train``, ``dryrun``, ``roofline`` and ``mesh`` are not
ported yet."""
