"""Placement rules for the production mesh (paper §G), and their use.

The JAX package states them as GSPMD ``PartitionSpec`` trees; here each
leaf's spec is JAX's own form -- a tuple with one entry per tensor
dimension, each entry a mesh-axis name, a tuple of names or ``None`` --
so the rules compare entry by entry with the JAX package's trees, and
``to_placements`` turns a spec into ``torch.distributed.tensor``
placements on a ``DeviceMesh``.

Axis roles on the mesh ``("data", "model")`` / ``("pod", "data",
"model")``:

* ``pod`` + ``data`` -- data parallelism (batch x ensemble in FCN3
  terms), plus FSDP-style weight sharding for the large LMs;
* ``model`` -- the paper's domain decomposition axis: latitude for FCN3,
  sequence / experts / heads for the LMs; FCN3's ensemble-parallel
  training puts the ensemble on it (``TrainConfig.member_axes``).

Leaves are given as a mapping from path (``"blocks/0/conv/w_re"`` or the
module form ``"blocks.0.conv.w_re"``) to anything with a ``.shape``
(tensors, ``meta`` tensors, numpy arrays).  Rules match the last path
component and return specs for the *trailing* dimensions, padded with
``None`` in front, so stacked and unstacked layer layouts get the same
rule.

The rules are applied, through ``sanitize_specs`` (an entry whose mesh
size does not divide its dim is dropped, as in the reference), by
``local_blocks`` -- each rank's block of every split leaf, through
``block_of`` (a state dict from ``train/checkpoint.py``'s ``arrays.npz``
onto a rank) -- ``place_parameters`` (a module's split parameters
replaced by this rank's blocks) and ``gather_blocks``, the inverse,
which gathers a rank's blocks back into whole leaves (a checkpoint is
always written whole, in the reference's format).  The trainer places
FCN3's parameters by ``fcn3_param_specs``: replicated in ``"domain"``
and ensemble mode, the latent channels over the model axis in
``"channel"`` mode (``distributed/channel.py``); the launcher slices
each batch by ``fcn3_batch_specs``.  The LMs apply the expert rule of
``lm_param_specs`` alone (``lm_expert_specs``: the MoE stacks' experts
over the model axis); its FSDP and tensor-parallel entries, and
``fsdp=True`` of ``fcn3_param_specs`` (which the JAX package never
passes either), stay tables.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

DP = "data"     # FSDP / batch axis (pod handled by the caller)
MP = "model"    # tensor/expert/sequence-parallel axis

Spec = tuple


def _entry(e):
    # a one-name tuple is that name, as in JAX's PartitionSpec
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


def _pad(spec: tuple, ndim: int) -> Spec:
    return (None,) * (ndim - len(spec)) + tuple(_entry(e) for e in spec)


def _ndim(leaf) -> int:
    return len(tuple(leaf.shape))


def _name(path: str) -> str:
    return path.replace(".", "/").split("/")[-1]


def _axis_sizes(mesh) -> dict[str, int]:
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def sanitize_specs(mesh, specs: Mapping[str, Spec],
                   structs: Mapping[str, Any]) -> dict[str, Spec]:
    """Drop sharding entries whose mesh-axis product does not divide the
    dimension (e.g. whisper's vocab 51865 cannot shard 16 ways).
    ``mesh``: a ``DeviceMesh`` or a mapping of axis name -> size."""
    sizes = _axis_sizes(mesh)

    def div(entry) -> int:
        if entry is None:
            return 1
        n = 1
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            n *= sizes[a]
        return n

    out = {}
    for path, spec in specs.items():
        shape = tuple(structs[path].shape)
        entries = tuple(spec) + (None,) * (len(shape) - len(spec))
        out[path] = tuple(e if shape[i] % div(e) == 0 else None
                          for i, e in enumerate(entries))
    return out


def to_placements(spec: Spec, mesh) -> tuple:
    """``torch.distributed.tensor`` placements of ``spec`` on ``mesh``:
    one per mesh dimension, ``Shard(d)`` where tensor dim d names that
    axis, else ``Replicate()``.  An axis named by two tensor dims raises;
    a tensor dim that names several axes shards on each of them."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    placements = [Replicate() for _ in names]
    seen = set()
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a in seen:
                raise ValueError(f"mesh axis {a!r} named twice in {spec}")
            seen.add(a)
            placements[names.index(a)] = Shard(d)
    return tuple(placements)


def block_of(entry, mesh) -> tuple[int, int]:
    """This rank's block of a tensor dim whose spec entry is ``entry``
    and the number of blocks: the named mesh axes, major to minor
    (``(0, 1)`` for ``None``)."""
    idx, n = 0, 1
    for a in (() if entry is None
              else entry if isinstance(entry, tuple) else (entry,)):
        size = mesh.size(tuple(mesh.mesh_dim_names).index(a))
        idx, n = idx * size + mesh.get_local_rank(a), n * size
    return idx, n


def _blocks_index(spec: Spec, shape: tuple, mesh) -> tuple:
    """The index of this rank's block of a leaf of ``shape`` placed by
    ``spec`` (a slice per dim)."""
    index = []
    for d, entry in enumerate(tuple(spec) + (None,) * (len(shape)
                                                       - len(spec))):
        i, n = block_of(entry, mesh)
        if shape[d] % n:
            raise ValueError(f"dim {d} of {shape} does not split over {n} "
                             "ranks: sanitize the specs first")
        size = shape[d] // n
        index.append(slice(i * size, (i + 1) * size))
    return tuple(index)


def is_split(spec: Spec) -> bool:
    """Whether ``spec`` places its leaf on any mesh axis."""
    return any(e is not None for e in spec)


def local_blocks(leaves: Mapping[str, Any], specs: Mapping[str, Spec],
                 mesh) -> dict[str, Any]:
    """This rank's block of every leaf (tensors or numpy arrays) that
    ``specs`` splits, a contiguous copy; the other leaves as they are.
    ``specs`` must be sanitized (``sanitize_specs``)."""
    out = {}
    for path, leaf in leaves.items():
        spec = specs.get(path, ())
        if not is_split(spec):
            out[path] = leaf
            continue
        block = leaf[_blocks_index(spec, tuple(leaf.shape), mesh)]
        out[path] = (block.clone(memory_format=torch.contiguous_format)
                     if isinstance(block, torch.Tensor) else block.copy())
    return out


def gather_blocks(blocks: Mapping[str, Any], specs: Mapping[str, Spec],
                  mesh) -> dict[str, Any]:
    """``local_blocks``' inverse: every split leaf's blocks gathered from
    the ranks that hold them into the whole leaf, on every rank (the call
    is collective); the other leaves as they are."""
    from repro_torch.distributed import compat
    out = {}
    for path, t in blocks.items():
        spec = specs.get(path, ())
        for d, entry in enumerate(spec):
            if entry is not None:
                axes = entry if isinstance(entry, tuple) else (entry,)
                t = compat.all_gather(t, compat.mesh_group(mesh, axes), d)
        out[path] = t
    return out


def place_parameters(module, specs: Mapping[str, Spec], mesh) -> list[str]:
    """Replace every parameter of ``module`` that ``specs`` (sanitized,
    keyed by the module's dotted names) splits by this rank's block of
    it, a parameter of its own with the same ``requires_grad``; returns
    the names placed."""
    params = {k: p for k, p in module.named_parameters()
              if is_split(specs.get(k, ()))}
    blocks = local_blocks({k: p.detach() for k, p in params.items()}, specs,
                          mesh)
    for name, p in params.items():
        owner, _, leaf = name.rpartition(".")
        setattr(module.get_submodule(owner), leaf, torch.nn.Parameter(
            blocks[name], requires_grad=p.requires_grad))
    return list(params)


# ---------------------------------------------------------------------------
# LMs
# ---------------------------------------------------------------------------

def lm_param_specs(cfg, params: Mapping[str, Any], data_axis=DP,
                   model_axis=MP) -> dict[str, Spec]:
    """LM parameters: 2-D projections (in, out) -> (FSDP over data, TP over
    model) for up-projections and the transpose for down-projections;
    3-D MoE expert stacks: experts over the model axis, plus FSDP on the
    feature dim.  ``cfg``: the ``ArchConfig``."""
    n_exp = cfg.moe.n_experts if cfg.moe else -1

    def spec_for(path, leaf) -> Spec:
        name, nd, shape = _name(path), _ndim(leaf), tuple(leaf.shape)
        if (name in ("w_gate", "w_up", "w_down") and nd >= 3
                and n_exp in shape[-3:-2]):
            if name == "w_down":
                return _pad((model_axis, None, data_axis), nd)
            return _pad((model_axis, data_axis, None), nd)
        if name in ("wq", "wk", "wv", "w_uq", "w_uk", "w_uv", "w_dkv",
                    "w_dq", "w_gate", "w_up", "in_proj", "w1"):
            return _pad((data_axis, model_axis), nd)
        if name in ("wo", "w_down", "out_proj", "w2"):
            return _pad((model_axis, data_axis), nd)
        if name in ("embed", "lm_head", "conv_w"):
            return _pad((None, model_axis), nd)
        return _pad((), nd)  # norms, biases, scalars: replicated

    return {p: spec_for(p, leaf) for p, leaf in params.items()}


def lm_expert_specs(cfg, params: Mapping[str, Any], model_axis=MP
                    ) -> dict[str, Spec]:
    """The part of ``lm_param_specs`` the port applies: its model-axis
    entry on the expert dim of the MoE stacks (E, D, F) / (E, F, D),
    stacked or not; every other entry of every leaf replicated."""
    def experts_only(spec: Spec) -> Spec:
        n = len(spec)
        return tuple(e if i == n - 3 and e == _entry(model_axis) else None
                     for i, e in enumerate(spec))

    return {p: experts_only(s) for p, s in
            lm_param_specs(cfg, params, model_axis=model_axis).items()}


def lm_opt_specs(param_specs: Mapping[str, Spec]) -> dict:
    """Adam state mirrors the parameter sharding."""
    return {"step": (), "mu": dict(param_specs), "nu": dict(param_specs)}


def lm_batch_specs(batch: Mapping[str, Any], dp_axes: tuple[str, ...],
                   model_axis=MP) -> dict[str, Spec]:
    """Training batch: the global batch over all data axes."""
    return {p: _pad((dp_axes,) if _ndim(leaf) else (), _ndim(leaf))
            for p, leaf in batch.items()}


def lm_cache_specs(cache: Mapping[str, Any], dp_axes: tuple[str, ...],
                   batch: int, model_axis=MP) -> dict[str, Spec]:
    """Decode caches: KV / latent caches batch over the data axes and
    sequence over the model axis; SSM states their state dim over the
    model axis."""
    def spec_for(path, leaf) -> Spec:
        name, nd = _name(path), _ndim(leaf)
        if name in ("k", "v"):           # (..., B, S, H, D)
            return _pad((dp_axes, model_axis, None, None), nd)
        if name in ("c_kv", "k_rope"):   # (..., B, S, R)
            return _pad((dp_axes, model_axis, None), nd)
        if name == "ssm":                # (..., B, H, P, N)
            return _pad((dp_axes, None, None, model_axis), nd)
        if name == "conv":               # (..., B, K-1, C)
            return _pad((dp_axes, None, model_axis), nd)
        return _pad((), nd)

    return {p: spec_for(p, leaf) for p, leaf in cache.items()}


# ---------------------------------------------------------------------------
# FCN3 (paper-faithful domain decomposition)
# ---------------------------------------------------------------------------

def fcn3_param_specs(params: Mapping[str, Any], data_axis=DP,
                     model_axis=MP, fsdp: bool = False,
                     mode: str = "domain") -> dict[str, Spec]:
    """FCN3 weights.

    ``mode="domain"`` (paper): replicated over the model axis -- the
    domain decomposition shards data, not weights (paper G.2).
    ``mode="channel"``: tensor parallelism on the latent channels (block
    DISCO conv C_out, spectral filter C_out, MLP hidden).  ``fsdp=True``
    also shards the remaining big leaves' first dim over data.
    """
    def spec_for(path, leaf) -> Spec:
        name, nd = _name(path), _ndim(leaf)
        parent = path.replace(".", "/")
        if mode == "channel":
            if name == "weight" and "blocks" in parent and nd >= 3:
                return _pad((model_axis, None, None), nd)
            if name in ("w_re", "w_im"):
                return _pad((model_axis, None, None), nd)
            if name == "w1":
                return _pad((model_axis, None), nd)
            if name == "b1":
                return _pad((model_axis,), nd)
            if name == "w2":
                return _pad((None, model_axis), nd)
        if fsdp and nd >= 2:
            return _pad((data_axis,) + (None,) * (nd - 1), nd)
        return _pad((), nd)

    return {p: spec_for(p, leaf) for p, leaf in params.items()}


def fcn3_buffer_specs(buffers: Mapping[str, Any], model_axis=MP
                      ) -> dict[str, Spec]:
    """Geometry buffers: psi / psi_band (K, H_out, S, .) and lat_idx
    (H_out, S) over the model axis along H_out; the Legendre tables and
    the small wrap-row and live-tap buffers replicated."""
    def spec_for(path, leaf) -> Spec:
        name, nd = _name(path), _ndim(leaf)
        if name in ("psi", "psi_band"):
            return _pad((None, model_axis, None, None), nd)
        if name == "lat_idx":
            return _pad((model_axis, None), nd)
        if name in ("wpct", "pct"):
            return _pad((None, None, None), nd)
        return _pad((), nd)

    return {p: spec_for(p, leaf) for p, leaf in buffers.items()}


def fcn3_batch_specs(batch: Mapping[str, Any], dp_axes: tuple[str, ...],
                     model_axis=MP, mode: str = "domain"
                     ) -> dict[str, Spec]:
    """FCN3 batches: the batch over the data axes; latitude over the model
    axis in ``"domain"`` mode (paper Fig. 2), unsharded in ``"channel"``
    mode."""
    def spec_for(leaf) -> Spec:
        nd = _ndim(leaf)
        if nd < 3:
            return _pad((), nd)
        lat = model_axis if mode == "domain" else None
        return _pad((dp_axes,) + (None,) * (nd - 3) + (lat, None), nd)

    return {p: spec_for(leaf) for p, leaf in batch.items()}

