"""Distribution on ``torch.distributed`` (paper §4, App. G: Algorithms 1-3).

* ``compat`` -- the collectives the rank-local bodies use, with JAX's
  tiled semantics and gradients;
* ``dist_sht`` / ``dist_disco`` / ``dist_crps`` -- the rank-local bodies
  of the distributed SHT (Alg. 1), DISCO convolution (Alg. 2) and
  ensemble CRPS (Alg. 3), each with its kernel inside on a CUDA tensor;
* ``sharding`` -- the placement rules of the JAX package's GSPMD specs;
* ``world`` -- spawns a local world of processes over a ``FileStore``;
* ``selftest`` -- ``python -m repro_torch.distributed.selftest``.

The trainer's ensemble parallelism (``TrainConfig.member_axes``) lives in
``repro_torch.train.trainer``, the meshes in ``repro_torch.launch.mesh``.
"""
