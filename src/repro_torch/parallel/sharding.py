"""Logical-axis sharding resolver (MaxText-style logical axis rules), as the
reference's ``parallel/sharding.py``.

Every parameter and cache leaf carries a tuple of *logical* dim names
(``Model.param_axes()``, ``Model.cache_axes()``). A rule table maps each
logical name to an ordered list of mesh-axis candidates; the resolver
assigns the first candidate whose size divides the dimension and whose mesh
axes are not already used by another dim of the same tensor. This gives:

  * automatic fallbacks (e.g. heads -> replicated attention when the head
    count does not divide the model axis — minicpm's 36 heads on a 16-way
    axis),
  * per-experiment overrides (swap rule tables, not model code),
  * safe behaviour on any mesh (axes absent from the mesh are skipped).

A mesh is anything with ``axis_names`` and a ``shape`` mapping (the
descriptions of ``launch/mesh.py``), or a ``torch.distributed`` DeviceMesh
(its ``mesh_dim_names`` and ``size(i)``). ``shardings_for`` gives each
parameter's DTensor placements, the counterpart of a ``NamedSharding``.

The port's model code is rank-local. Where a DeviceMesh over a live
process group is installed (``launch/mesh.make_host_mesh`` with a group
initialised), each rank holds its own block of every activation, the block
that the activation's spec gives it (``block``), and ``constrain`` and
``constrain_act`` are identities on it: the block already has the layout
the spec names. The MoE FFN crosses ranks (``models/moe.py``, through
``parallel/collectives.py``), and where the installed tokens split the
sequence so do attention, the SSD and the conv (``token_seq_entry``;
``kernels/ops.py``). The reference decides its MoE path on the
*global* shape of the activations, which a rank does not see: the launcher
installs the global (batch, seq) of the tokens with the rules
(``set_activation_sharding(..., tokens=)``), and ``global_shape`` gives a
rank's activation its global shape from it. A mesh description larger
than one device has no process group and no rank: ``constrain`` and
``set_activation_sharding`` raise on it.

The partitioned steps (``launch/steps.py`` with a mesh) hold every
parameter, optimizer moment, batch leaf and cache leaf as a ``DTensor``
placed by the resolver (``distribute``, ``dzeros``): the counterpart of
``device_put`` with a ``NamedSharding``. On a DTensor, ``constrain``
redistributes to the placements of the spec, the counterpart of
``with_sharding_constraint``, and DTensor's sharding propagation inserts
the collectives between two pins, as GSPMD does. The hand-written kernels
run on each rank's local block (``kernels/ops.py`` under ``local_map``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

# A rule: logical name -> ordered candidates; each candidate is a tuple of
# mesh axes used together on that dim (e.g. ("pod", "data") for global batch).
LogicalRules = Dict[str, List[Tuple[str, ...]]]


class PartitionSpec(tuple):
    """One tensor's spec: per dim ``None``, a mesh axis name, or a tuple of
    names. A tuple, so it compares equal to any sequence of the same
    entries (the reference's ``jax.sharding.PartitionSpec`` among them)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a mesh description or a DeviceMesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None and hasattr(mesh, "size"):
        return {n: int(mesh.size(i)) for i, n in enumerate(names)}
    return {n: int(dict(mesh.shape)[n]) for n in mesh.axis_names}


def mesh_size(mesh) -> int:
    return math.prod(mesh_axes(mesh).values())


def dp_heavy_rules() -> LogicalRules:
    """Fully-sharded data parallelism (ZeRO-3 style) for archs whose head
    counts do not divide the model axis (minicpm 36H, qwen 40H, llava 56H,
    gemma3 4H): the batch spreads over data x model (with graceful fallback
    when the per-step batch is smaller), weights shard over ('data','model')
    on their embed dim and are all-gathered at use. Attention runs fully
    batch-parallel — no replicated compute, no contraction-dim sums."""
    return {
        "batch": [("pod", "data", "model"), ("data", "model"),
                  ("pod", "data"), ("data",)],
        # sequence parallelism: when the batch cannot cover data x model
        # (prefill B=32), activations shard their seq dim on the idle model
        # axis instead of replicating 16x (K/V gathered per layer).
        "seq": [("model",)],
        "kv_seq": [("model",)],
        "embed": [("data", "model"), ("data",)],
        "vocab": [("model",)],
        "heads": [],
        "head_dim": [],
        "kv_heads": [],
        "ff": [],
        "experts": [("model",)],
        "expert_ff": [],
        "state": [], "conv": [], "layers": [], "frames": [],
        "capacity": [("data",)], "moe_tokens": [("data",)],
        "vocab_embed": [],          # embed-table model dim: replicated
        "loss_batch": [("data", "model"), ("data",)],
        "cache_state": [("model",)],  # SSM decode state N dim
        "none": [],
    }


def rules_for(cfg, mesh, fsdp: bool = True) -> LogicalRules:
    """Pick the baseline rule table for an arch on this mesh.

    * heads AND kv_heads divide the model axis -> full TP (default rules).
    * only kv_heads indivisible (jamba/phi: Hq=64/32, Hkv=8 on a 16-way
      axis) -> the GQA (Hkv, G) reshape cannot stay sharded, so attention
      runs batch-parallel while MLP/MoE keep model-axis TP.
    * heads indivisible (minicpm/qwen/llava/gemma3) -> fully-sharded DP.
    """
    model_size = mesh_axes(mesh).get("model", 1)
    if cfg.n_heads and cfg.n_heads % model_size != 0:
        return dp_heavy_rules()
    if cfg.n_kv_heads and cfg.n_kv_heads % model_size != 0:
        rules = default_rules(fsdp)
        rules["heads"] = []
        rules["kv_heads"] = []
        rules["seq"] = [("model",)]   # sequence-parallel attention activations
        return rules
    return default_rules(fsdp)


def batch_dp_degree(rules: LogicalRules, mesh, global_batch: int) -> int:
    """Data-parallel degree the 'batch' rule will actually achieve for this
    global batch (first candidate whose size divides it)."""
    sizes = mesh_axes(mesh)
    for cand in rules.get("batch", []):
        cand = tuple(a for a in cand if a in sizes)
        if not cand:
            continue
        size = math.prod(sizes[a] for a in cand)
        if size and global_batch % size == 0:
            return size
    return 1


def default_rules(fsdp: bool = True) -> LogicalRules:
    """Baseline rule table: DP(+pod) on batch, TP on model, FSDP on embed."""
    return {
        "batch": [("pod", "data"), ("data",)],
        "seq": [],
        "kv_seq": [("model",)],          # decode caches: depth-shard fallback
        "embed": [("data",)] if fsdp else [],
        "vocab": [("model",)],
        "heads": [("model",)],
        # no head_dim fallback by default: contraction-dim TP would make
        # every attention logits tile a cross-device sum. Heads-indivisible
        # archs run attention batch-parallel with FSDP'd weights instead.
        "head_dim": [],
        "kv_heads": [("model",)],
        "ff": [("model",)],
        "experts": [("model",)],
        "expert_ff": [],
        "state": [],
        "conv": [],
        "layers": [],
        "frames": [],
        "capacity": [("data",)],   # MoE (E,C,D) buffers: C over data
        "moe_tokens": [("data",)],
        "vocab_embed": [],         # embed-table model dim: replicated (small)
        "loss_batch": [("data",)], # CE logits: batch on data so vocab->model
        "cache_state": [("model",)],  # SSM decode state N dim
        "none": [],
    }


# Dims are assigned mesh axes in priority order, so e.g. `kv_heads` gets the
# model axis before the `kv_seq` fallback competes for it.
_PRIORITY = {
    "batch": 0, "loss_batch": 0, "experts": 1, "vocab": 1, "ff": 1,
    "heads": 1, "kv_heads": 1, "embed": 2, "head_dim": 3, "kv_seq": 4,
    "moe_tokens": 4,
}


def spec_for(axes: Sequence[Optional[str]], shape: Sequence[int],
             rules: LogicalRules, mesh) -> PartitionSpec:
    """Resolve one tensor's PartitionSpec from its logical axes."""
    assert len(axes) == len(shape), (axes, shape)
    sizes = mesh_axes(mesh)
    used: set = set()
    out: List = [None] * len(axes)
    order = sorted(range(len(axes)),
                   key=lambda i: _PRIORITY.get(axes[i] or "none", 9))
    for i in order:
        name, dim = axes[i], shape[i]
        for cand in rules.get(name or "none", []):
            cand = tuple(a for a in cand if a in sizes)
            if not cand or any(a in used for a in cand):
                continue
            size = math.prod(sizes[a] for a in cand)
            if size > 0 and dim % size == 0:
                out[i] = cand if len(cand) > 1 else cand[0]
                used.update(cand)
                break
    return PartitionSpec(*out)


def tree_specs(axes: Mapping[str, Tuple], params: Mapping[str, torch.Tensor],
               rules: LogicalRules, mesh) -> Dict[str, PartitionSpec]:
    """``{name: PartitionSpec}`` for flat ``{name: tensor}`` parameters (or
    cache leaves) and an axes mapping with the same keys."""
    if set(axes) != set(params):
        raise KeyError(f"axes and tensors differ in "
                       f"{sorted(set(axes) ^ set(params))[:4]}")
    return {k: spec_for(axes[k], tuple(t.shape), rules, mesh)
            for k, t in params.items()}


def placements(spec: PartitionSpec, mesh) -> tuple:
    """The DTensor placements of one spec: for each mesh dim, ``Shard(d)``
    of the tensor dim it splits, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    by_axis = {}
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            by_axis[a] = d
    return tuple(Shard(by_axis[a]) if a in by_axis else Replicate()
                 for a in mesh_axes(mesh))


def live_placements(spec: PartitionSpec, mesh) -> tuple:
    """``placements`` as the DTensors of a step hold them: on an axis of
    one rank a shard is the whole dim, and is held as ``Replicate()``
    (DTensor refuses to reshape a dim sharded over one rank)."""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() if n == 1 else q for q, n in
                 zip(placements(spec, mesh), mesh_axes(mesh).values()))


def shardings_for(axes: Mapping[str, Tuple],
                  params: Mapping[str, torch.Tensor], rules: LogicalRules,
                  mesh) -> Dict[str, tuple]:
    """``{name: DTensor placements}``: the torch counterpart of the
    reference's tree of ``NamedSharding``."""
    return {k: placements(s, mesh)
            for k, s in tree_specs(axes, params, rules, mesh).items()}


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry: ``None``, a name or a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def is_live(mesh) -> bool:
    """A DeviceMesh over a process group (as against a description)."""
    return hasattr(mesh, "get_group")


def _one_device(mesh) -> bool:
    return mesh is None or mesh_size(mesh) == 1


def coordinates(mesh) -> Dict[str, int]:
    """``{axis name: this rank's index along it}`` on a live mesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def block_index(entry, mesh) -> Tuple[int, int]:
    """(this rank's block, number of blocks) of a dim laid out by one spec
    entry: a tuple of axes numbers the blocks row-major, its first axis
    the slowest (as ``shard_map`` cuts them)."""
    sizes, coords = mesh_axes(mesh), coordinates(mesh)
    index, count = 0, 1
    for a in entry_axes(entry):
        index, count = index * sizes[a] + coords[a], count * sizes[a]
    return index, count


def block(t: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """This rank's block of a whole tensor laid out by ``spec`` (a view):
    what ``shard_map``'s ``in_specs`` hand the rank."""
    for dim, entry in enumerate(spec):
        index, count = block_index(entry, mesh)
        if count > 1:
            size = t.shape[dim] // count
            t = t.narrow(dim, index * size, size)
    return t


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _from_block(local: torch.Tensor, spec: PartitionSpec, mesh):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, live_placements(spec, mesh),
                              run_check=False)


def distribute(tensors: Mapping[str, torch.Tensor],
               axes: Mapping[str, Tuple], rules: LogicalRules, mesh
               ) -> Dict[str, torch.Tensor]:
    """Whole tensors as DTensors on a live ``mesh``, each placed by the spec
    of its logical axes: the counterpart of ``device_put`` with a
    ``NamedSharding``. Every rank passes the same whole tensors and keeps
    its block of each (``block``; no collective)."""
    specs = tree_specs(axes, tensors, rules, mesh)
    return {k: _from_block(_owned(block(t, specs[k], mesh)), specs[k], mesh)
            for k, t in tensors.items()}


def _owned(t: torch.Tensor) -> torch.Tensor:
    """A block as a tensor of its own: a copy where it is a view of a
    larger storage (``contiguous`` keeps a contiguous view, such as one
    expert of a (E, D, F) weight, and the whole storage with it)."""
    if t.untyped_storage().nbytes() > t.numel() * t.element_size():
        return t.clone(memory_format=torch.contiguous_format)
    return t.contiguous()


def dzeros(shape: Sequence[int], axes: Sequence[Optional[str]],
           rules: LogicalRules, mesh, dtype, device) -> torch.Tensor:
    """A DTensor of zeros of global ``shape`` placed by the spec of
    ``axes``; each rank allocates its block only."""
    spec = spec_for(axes, tuple(shape), rules, mesh)
    local = list(shape)
    sizes = mesh_axes(mesh)
    for d, entry in enumerate(spec):
        for a in entry_axes(entry):
            local[d] //= sizes[a]
    return _from_block(torch.zeros(local, dtype=dtype, device=device), spec,
                       mesh)


def at_use(w: torch.Tensor) -> torch.Tensor:
    """A layer's weight where a product uses it: a DTensor weight is
    gathered over the mesh axes that the installed rules give the batch
    (FSDP: data and pod; under ``dp_heavy_rules`` the model axis too),
    keeping its model-parallel split, so each rank multiplies its batch
    block by the weights of its own heads or features (otherwise DTensor
    may choose to repeat a product on several ranks). Else ``w``."""
    rules = installed()[0]
    if not is_dtensor(w) or rules is None:
        return w
    from torch.distributed.tensor import Replicate, Shard
    fsdp = {a for cand in rules.get("batch", []) for a in cand}
    names = w.device_mesh.mesh_dim_names
    target = tuple(Replicate() if names[i] in fsdp and isinstance(q, Shard)
                   else q for i, q in enumerate(w.placements))
    if target == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, target)


def local_product(fn, x: torch.Tensor, weights: Sequence[torch.Tensor],
                  x_on_model, out_on_model, x_grad_on_model) -> torch.Tensor:
    """``fn(x, *weights)`` on each rank's blocks (Megatron's tensor
    parallelism), for weights already gathered at use (``at_use``). A
    mesh axis that splits the first weight is a model-parallel axis: each
    weight keeps its split there, x is laid out as ``x_on_model``, the
    output as ``out_on_model`` (a ``Partial`` where fn sums over the split
    features) and x's gradient as ``x_grad_on_model``. On any other axis
    x keeps its split (the batch), and so do the output and x's gradient;
    the weights are whole there and their gradients partial over it where
    x is split. DTensor's own rules for the products inside fn may repeat
    some of them, the backward's most, on every rank of the model axis."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    x_pl, out_pl, xg_pl = [], [], []
    w_pl = [[] for _ in weights]
    wg_pl = [[] for _ in weights]
    for i, q in enumerate(x.placements):
        if isinstance(weights[0].placements[i], Shard):
            x_pl.append(x_on_model)
            out_pl.append(out_on_model)
            xg_pl.append(x_grad_on_model)
            for w, a, g in zip(weights, w_pl, wg_pl):
                a.append(w.placements[i])
                g.append(w.placements[i])
            continue
        q = q if isinstance(q, Shard) else Replicate()
        x_pl.append(q)
        out_pl.append(q)
        xg_pl.append(q)
        for a, g in zip(w_pl, wg_pl):
            a.append(Replicate())
            g.append(Partial() if isinstance(q, Shard) else Replicate())
    return local_map(fn, out_placements=out_pl,
                     in_placements=(tuple(x_pl),) + tuple(map(tuple, w_pl)),
                     in_grad_placements=(tuple(xg_pl),)
                     + tuple(map(tuple, wg_pl)),
                     device_mesh=x.device_mesh, redistribute_inputs=True)(
        x, *weights)


def constrain(x: torch.Tensor, axes: Sequence[Optional[str]],
              rules: LogicalRules, mesh) -> torch.Tensor:
    """Pin an activation's sharding by logical names. A DTensor is
    redistributed to the placements of its spec (a no-op where it has
    them). A plain tensor: the identity on one device and on a live mesh,
    where x is already the rank's block; a description larger than one
    device has no rank to hold a block."""
    if is_dtensor(x):
        target = live_placements(spec_for(axes, tuple(x.shape), rules,
                                          x.device_mesh), x.device_mesh)
        if tuple(x.placements) != target:
            x = x.redistribute(x.device_mesh, target)
        return x
    if _one_device(mesh) or is_live(mesh):
        return x
    raise NotImplementedError(
        f"constrain: activation sharding over the description "
        f"{mesh_axes(mesh)} has no process group; install a DeviceMesh")


# ---------------------------------------------------------------------------
# Activation-sharding context: model code calls constrain_act(x, axes) with
# logical names; a launcher installs (rules, mesh) before running, and on a
# live mesh the global (batch, seq) of the tokens. Identity when not
# installed, on one device and on a live mesh.
# ---------------------------------------------------------------------------

_ACT = {"rules": None, "mesh": None, "tokens": None}


def set_activation_sharding(rules: Optional[LogicalRules], mesh,
                            tokens: Optional[Tuple[int, int]] = None
                            ) -> None:
    """Install ``rules`` over ``mesh``; ``tokens`` is the global (batch,
    seq) of the activations that the model code will see, each rank
    holding its block of them."""
    if not _one_device(mesh) and not is_live(mesh):
        raise NotImplementedError(
            f"set_activation_sharding: the description {mesh_axes(mesh)} of "
            f"{mesh_size(mesh)} devices has no process group; install a "
            f"DeviceMesh")
    _ACT["rules"], _ACT["mesh"] = rules, mesh
    _ACT["tokens"] = None if tokens is None else tuple(tokens)


def installed() -> Tuple[Optional[LogicalRules], object]:
    """The installed (rules, mesh)."""
    return _ACT["rules"], _ACT["mesh"]


class activation_sharding:
    """``with activation_sharding(rules, mesh):`` installs them (and
    ``tokens``) for the block and puts back what was installed before."""

    def __init__(self, rules, mesh, tokens=None):
        self.args = (rules, mesh, tokens)

    def __enter__(self):
        self.saved = dict(_ACT)
        set_activation_sharding(*self.args)
        return self

    def __exit__(self, *exc):
        _ACT.update(self.saved)


def constrain_act(x: torch.Tensor, axes: Sequence[Optional[str]]
                  ) -> torch.Tensor:
    rules, mesh = _ACT["rules"], _ACT["mesh"]
    if rules is None or mesh is None or len(axes) != x.dim():
        return x
    return constrain(x, axes, rules, mesh)


def token_spec(shape: Sequence[int], rules: LogicalRules,
               mesh) -> PartitionSpec:
    """The spec of activations of global shape (B, S, D), as the reference
    resolves it in ``moe_ffn``."""
    return spec_for(("batch", "seq", None), tuple(shape), rules, mesh)


def global_shape(x: torch.Tensor) -> Tuple[int, int, int]:
    """The global (B, S, D) of a rank's block x (B_l, S_l, D) on the
    installed live mesh, from the installed tokens; raises where x is not
    the block those tokens give the rank (a decode step's activations
    under a prefill's tokens, say: the launcher installs each call's)."""
    rules, mesh, tokens = _ACT["rules"], _ACT["mesh"], _ACT["tokens"]
    if tokens is None:
        raise ValueError(
            "a live mesh is installed without the global (batch, seq) of "
            "the tokens: pass tokens= to set_activation_sharding")
    shape = (tokens[0], tokens[1], x.shape[-1])
    spec, sizes = token_spec(shape, rules, mesh), mesh_axes(mesh)
    local = tuple(n // math.prod(sizes[a] for a in entry_axes(e))
                  for n, e in zip(shape, spec))
    if local != tuple(x.shape):
        raise ValueError(
            f"activations of shape {tuple(x.shape)} are not a rank's block "
            f"{local} of the installed tokens {tokens} (spec {spec})")
    return shape


def split_entry(x: torch.Tensor, dim: int):
    """The spec entry (mesh axes, in the mesh's order) that splits ``dim``
    of a DTensor x, or None where no axis of more than one rank does."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    axes = tuple(n for n, q, size in zip(mesh.mesh_dim_names, x.placements,
                                         mesh_axes(mesh).values())
                 if q == Shard(dim % x.dim()) and size > 1)
    return axes or None


def token_seq_entry():
    """Where a live mesh is installed with the global tokens and the model
    code sees plain blocks of them: the spec entry that splits the
    sequence over ranks, or None (one device, DTensors, or a whole
    sequence on each rank)."""
    rules, mesh, tokens = _ACT["rules"], _ACT["mesh"], _ACT["tokens"]
    if mesh is None or rules is None or tokens is None or _one_device(mesh):
        return None
    entry = token_spec((tokens[0], tokens[1], 1), rules, mesh)[1]
    return entry if entry_axes(entry) else None
