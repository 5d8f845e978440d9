"""Command-line entry points: ``serve`` (the scored ensemble forecast),
``evaluate`` (the WB2 protocol over initial conditions), ``service`` and
``bundle`` (the forecast service and its warm-start bundles), ``train``
(one process or a mesh of ranks), ``lm`` (the Mamba-2 LM) and ``mesh``
(the device meshes they run on)."""
