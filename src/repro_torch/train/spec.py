"""The training engine: declarative policy and a step-builder registry.

``TrainSpec`` is one frozen, hashable value object holding every knob
that decides how a training step is built and what state layout it
trains against: the gradient compression method, the virtual shard
count ``V``, FSDP state sharding, the host overlap schedule of the
exchange rounds, microbatching and the rng policy.  Policy only: no
parameters, no mesh.  It is the dispatch key of the step-builder
registry and the layout fingerprint every checkpoint is stamped with
(``layout_stamp`` / ``check_restore_layout``), field for field the
reference's (``repro.train.spec``).

The legacy knobs (``TrainConfig.grad_compression`` /
``grad_accum_shards`` / ``fsdp`` / ``overlap`` / ``microbatches`` and
the duplicate ``OptConfig.grad_compression``) normalise through
``spec_for``: legacy spellings resolve to hash-equal specs, and
conflicting duplicates raise.

Step builders
-------------
``resolve_step_builder(spec)`` walks a registry of ``(name, match,
build)`` strategies front to back.  The built-ins:

  * ``plain``        — one grad + update step;
  * ``microbatch``   — sequential accumulation over ``spec.microbatches``
                       equal batch slices into fp32 accumulators;
  * ``elastic-dp``   — ``repro_torch.dist.compression.make_elastic_dp_step``
                       with replicated state;
  * ``elastic-fsdp`` — the same exchange with row-sharded
                       params/moments.

A step's ``rng`` argument is the fold function of one step,
``rng(i) -> torch.Generator`` (``rng(None)`` the step's own generator):
the Trainer passes ``functools.partial(train.loop.step_generator, seed,
step, device)``, so slice ``i`` of a microbatched step and virtual shard
``v`` of an elastic step draw from ``(seed, step, i)`` alone, whatever
the world size — the port's counterpart of the reference's per-shard
``fold_in``.

The layout facade at the bottom (``dp_degree``, ``zeros_error_state``,
``error_state_shapes``, ``state_shardings``, ``payload_metrics``) is the
policy-level surface over ``repro_torch.dist.compression``; placement
specs are tuples of mesh axis names (``("data",)`` row-sharded, ``()``
replicated).  On a ``(D, S)`` mesh the data-parallel degree is D alone
(the model is replicated over ``"model"``): V divides by D, not D·S,
the error state is ``[V, ...]`` of whole leaves, and the layout stamp
holds no mesh shape, so a checkpoint written at ``(D, S)`` restores on
any ``(D', S')`` whose D' divides V.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

METHODS = ("none", "bf16", "int8")
OVERLAP_MODES = ("none", "dispatch", "backward")
RNG_POLICIES = ("fold", "none")


def _normalise_overlap(overlap) -> str:
    """Legacy bools meant: True = the round-level dispatch double
    buffer, False = the serial loop.  None = default."""
    if overlap is None or overlap is True:
        return "dispatch"
    if overlap is False:
        return "none"
    return overlap


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """How a training step is built.  Frozen and hashable: specs are
    registry-dispatch and checkpoint-layout keys.

    compression   gradient payload compression ("none" | "bf16" |
                  "int8"); only meaningful on the elastic path
    accum_shards  virtual shard count V of the elastic exchange, or None
                  for "the mesh's data-parallel degree" (``resolve_accum``).
                  A run constant: it fixes the error-state shapes, the
                  fsdp row classification and the reduction order, which
                  makes the step bitwise across world sizes dividing V
    fsdp          row-shard params/moments over the data axis (elastic
                  path only)
    overlap       host schedule of the exchange rounds ("none" serial |
                  "dispatch" double-buffered rounds | "backward"
                  backward of round r+1 before waiting on the exchange
                  of round r).  All modes are bitwise identical, so it
                  is not part of the checkpoint layout
    microbatches  sequential gradient accumulation on the plain path
    rng           "fold" passes a per-step fold function, folded per
                  microbatch / virtual shard; "none" builds rng-less steps
    elastic       whether the step is the elastic exchange at all
                  (``spec_for`` derives it from the legacy knobs)
    """
    compression: str = "none"
    accum_shards: Optional[int] = None
    fsdp: bool = False
    overlap: str = "dispatch"
    microbatches: int = 1
    rng: str = "fold"
    elastic: bool = False

    def __post_init__(self):
        if self.compression not in METHODS:
            raise ValueError(
                f"unknown grad compression {self.compression!r}: "
                f"expected one of {METHODS}")
        if not isinstance(self.overlap, str) \
                or self.overlap not in OVERLAP_MODES:
            raise ValueError(
                f"unknown overlap mode {self.overlap!r}: expected one "
                f"of {OVERLAP_MODES} (spec_for accepts legacy bools)")
        if self.rng not in RNG_POLICIES:
            raise ValueError(
                f"unknown rng policy {self.rng!r}: expected one of "
                f"{RNG_POLICIES}")
        object.__setattr__(self, "microbatches", int(self.microbatches))
        if self.microbatches < 1:
            raise ValueError(
                f"microbatches={self.microbatches} must be >= 1")
        if self.accum_shards is not None:
            object.__setattr__(self, "accum_shards",
                               int(self.accum_shards))
            if self.accum_shards < 1:
                raise ValueError(
                    f"accum_shards={self.accum_shards} must be >= 1")
        if not self.elastic:
            if self.compression != "none":
                raise ValueError(
                    f"compression={self.compression!r} requires "
                    f"elastic=True (spec_for derives it from the "
                    f"legacy knobs)")
            if self.accum_shards is not None:
                raise ValueError(
                    "accum_shards is the elastic exchange's virtual "
                    "shard count; set elastic=True (or use "
                    "microbatches for plain sequential accumulation)")
            if self.fsdp:
                raise ValueError(
                    "fsdp=True requires elastic=True: the row-sharded "
                    "state layout only exists for the elastic "
                    "exchange")
            if self.overlap != "dispatch":
                raise ValueError(
                    f"overlap={self.overlap!r} schedules the elastic "
                    f"exchange's collect rounds; non-elastic specs "
                    f"must leave it at the default 'dispatch'")
        elif self.microbatches != 1:
            raise ValueError(
                "the elastic exchange already accumulates over "
                "accum_shards virtual shards; set microbatches=1")

    def resolve_accum(self, mesh) -> int:
        """The concrete virtual shard count V on this mesh."""
        if self.accum_shards is not None:
            return int(self.accum_shards)
        from repro_torch.dist import compression
        return compression.dp_shard_count(mesh)

    def layout_stamp(self, mesh=None) -> dict:
        """The checkpoint-layout fingerprint: the spec's fields plus the
        resolved V, stamped into every checkpoint's manifest metadata and
        verified on restore by ``check_restore_layout``.  Wall-clock
        fields (overlap) are stamped but not enforced."""
        d = dataclasses.asdict(self)
        d["resolved_accum_shards"] = (
            self.resolve_accum(mesh) if (self.elastic and mesh is not
                                         None) else self.accum_shards)
        return d


# the stamp's keys that must match for a checkpoint to restore onto a
# spec: they decide the state's shapes and layout (err rows [V, ...],
# fsdp rows) or the reduction trajectory (the method); overlap,
# microbatches and rng are wall-clock policy
_LAYOUT_KEYS = ("elastic", "compression", "fsdp",
                "resolved_accum_shards")


def check_restore_layout(stamp: Optional[dict], spec: TrainSpec,
                         resolved_accum: Optional[int]) -> None:
    """Verify a checkpoint's ``train_spec`` stamp against the spec a run
    resumes with.  An empty stamp (a checkpoint written before stamps)
    restores unchecked.  Raises an actionable ValueError on a layout
    mismatch, before any array is read."""
    if not stamp:
        return
    have = dict(spec.layout_stamp())
    have["resolved_accum_shards"] = resolved_accum
    bad = []
    for k in _LAYOUT_KEYS:
        if k in stamp and stamp[k] != have.get(k):
            bad.append(f"{k}: checkpoint={stamp[k]!r} "
                       f"run={have.get(k)!r}")
    if bad:
        raise ValueError(
            "checkpoint layout does not match this run's TrainSpec — "
            + "; ".join(bad)
            + ". Resume with the original --grad-compression/"
            "--grad-accum-shards/--fsdp flags (any mesh whose "
            "data-parallel degree divides the stamped accum_shards "
            "works), or point --ckpt-dir at a fresh directory.")


def spec_for(*, grad_compression: Optional[str] = None,
             opt_grad_compression: Optional[str] = None,
             grad_accum_shards: Optional[int] = None,
             fsdp: bool = False, microbatches: int = 1,
             overlap=None, rng: str = "fold") -> TrainSpec:
    """Normalise the legacy kwargs into a ``TrainSpec``.  The step is
    elastic iff any of ``grad_compression`` (None = unset),
    ``grad_accum_shards`` or ``fsdp`` is set, or the effective method is
    not "none".  ``opt_grad_compression`` is the deprecated
    ``OptConfig.grad_compression`` duplicate ("none" = unset): either
    spelling alone resolves to the same spec, and both set to different
    methods raise.  ``overlap`` accepts the legacy bools."""
    tc, oc = grad_compression, opt_grad_compression
    if tc is not None and oc is not None and oc != "none" and tc != oc:
        raise ValueError(
            f"conflicting grad compression settings: TrainConfig."
            f"grad_compression={tc!r} vs OptConfig.grad_compression="
            f"{oc!r}. The OptConfig knob is a deprecated duplicate — "
            f"set the method in ONE place (prefer TrainConfig / "
            f"TrainSpec.compression) or make them agree.")
    method = tc if tc is not None else (oc if oc is not None
                                        else "none")
    elastic = (tc is not None or grad_accum_shards is not None
               or bool(fsdp) or method != "none")
    if elastic:
        if int(microbatches) > 1:
            raise ValueError(
                "grad_compression already accumulates over "
                "grad_accum_shards virtual shards; set microbatches=1")
        return TrainSpec(compression=method,
                         accum_shards=grad_accum_shards,
                         fsdp=bool(fsdp),
                         overlap=_normalise_overlap(overlap),
                         microbatches=1, rng=rng, elastic=True)
    return TrainSpec(overlap=_normalise_overlap(overlap),
                     microbatches=int(microbatches), rng=rng)


# ------------------------------------------------------ CLI flag cluster
def add_train_spec_args(ap, *, microbatches: bool = True) -> None:
    """The TrainSpec flag cluster of ``launch/train.py``, spelled as the
    reference's."""
    ap.add_argument("--grad-compression", default=None,
                    choices=list(METHODS),
                    help="elastic-deterministic dp exchange with this "
                         "payload compression (error feedback for "
                         "bf16/int8)")
    ap.add_argument("--grad-accum-shards", type=int, default=None,
                    help="fixed virtual shard count V for the elastic "
                         "exchange (default: the mesh's data-parallel "
                         "degree); a run constant — any mesh whose dp "
                         "degree divides V resumes bit-identically")
    ap.add_argument("--fsdp", action="store_true",
                    help="row-shard params/optimizer moments over the "
                         "data axis and exchange reduce-scatter-sized "
                         "payloads")
    ap.add_argument("--overlap", default="dispatch",
                    choices=list(OVERLAP_MODES),
                    help="host schedule for the exchange rounds: "
                         "serial, double-buffered dispatch, or "
                         "backward-of-next-round before waiting on the "
                         "current exchange — all bitwise identical")
    if microbatches:
        ap.add_argument("--microbatches", type=int, default=1,
                        help="sequential gradient accumulation on the "
                             "plain (non-elastic) path")


def spec_from_args(args) -> TrainSpec:
    """The spec of a namespace parsed through ``add_train_spec_args``."""
    return spec_for(
        grad_compression=getattr(args, "grad_compression", None),
        grad_accum_shards=getattr(args, "grad_accum_shards", None),
        fsdp=bool(getattr(args, "fsdp", False)),
        overlap=getattr(args, "overlap", None),
        microbatches=int(getattr(args, "microbatches", 1) or 1))


# ------------------------------------------------ step-builder registry
@dataclasses.dataclass(frozen=True)
class StepContext:
    """What a step builder needs besides the spec: ``loss_fn(values,
    batch[, generator])`` returning ``loss`` or ``(loss, aux)`` per
    ``has_aux``; the mesh (elastic builders); and the optimizer hook
    ``apply_fn(values, opt_state, grads[, grad_norm=]) -> (new_values,
    new_opt_state, stats)``; ``shapes``, the global values tree the fsdp
    row classification reads (the port's tensors carry no sharding)."""
    loss_fn: Callable
    mesh: Any = None
    apply_fn: Optional[Callable] = None
    has_aux: bool = False
    shapes: Any = None


_STEP_BUILDERS: List[Tuple[str, Callable[[TrainSpec], bool],
                           Callable[[TrainSpec, StepContext], Any]]] \
    = []


def register_step_builder(name: str,
                          match: Callable[[TrainSpec], bool],
                          build: Callable[[TrainSpec, StepContext],
                                          Any],
                          *, front: bool = True) -> None:
    """Register a step-construction strategy: ``match(spec)`` says
    whether ``build(spec, ctx)`` builds the step of a spec.  User
    registrations go in front (the last registered wins on overlap);
    the built-ins are appended at import."""
    entry = (name, match, build)
    if front:
        _STEP_BUILDERS.insert(0, entry)
    else:
        _STEP_BUILDERS.append(entry)


def unregister_step_builder(name: str) -> None:
    _STEP_BUILDERS[:] = [e for e in _STEP_BUILDERS if e[0] != name]


def step_builder_names() -> Tuple[str, ...]:
    return tuple(e[0] for e in _STEP_BUILDERS)


def resolve_step_builder(spec: TrainSpec):
    """The first registered strategy matching the spec, as ``(name,
    build)``."""
    for name, match, build in _STEP_BUILDERS:
        if match(spec):
            return name, build
    raise ValueError(
        f"no step builder matches {spec} — registered: "
        f"{step_builder_names()}; register one with "
        f"repro_torch.train.spec.register_step_builder(name, match, "
        f"build)")


def build_train_step(spec: TrainSpec, *, loss_fn, mesh=None,
                     apply_fn=None, has_aux: bool = False, shapes=None):
    """Resolve and run the step builder of ``spec``.  Plain and
    microbatch steps are ``step(values, opt_state, batch[, rng]) ->
    (new_values, new_opt, metrics)``; elastic steps are
    ``make_elastic_dp_step``'s."""
    if spec.elastic and mesh is None:
        raise ValueError(
            "grad_compression / grad_accum_shards / fsdp require a "
            "mesh")
    _, build = resolve_step_builder(spec)
    return build(spec, StepContext(loss_fn=loss_fn, mesh=mesh,
                                   apply_fn=apply_fn, has_aux=has_aux,
                                   shapes=shapes))


# ------------------------------------------------------------ built-ins
def accumulate_grads(loss_fn, n: int, values, batch, rng=None,
                     floats=None, *, has_aux: bool = False):
    """(floats, their gradients, metrics): the gradients of ``floats``
    (default: the float leaves of ``values``) of ``loss_fn(values,
    batch[, generator])``, the mean over ``n`` equal batch slices run in
    sequence into fp32 accumulators, slice i drawing from ``rng(i)``
    (``rng(None)`` when n == 1; no generator when ``rng`` is None); the
    metrics are the slices' mean.  The body of the plain and microbatch
    steps."""
    import torch

    from repro_torch.nn.module import tree_leaves

    if floats is None:
        floats = [x for x in tree_leaves(values)
                  if torch.is_floating_point(x)]
    rows = {int(v.shape[0]) for v in batch.values()}
    if len(rows) != 1 or next(iter(rows)) % n:
        raise ValueError(f"microbatches={n} must divide the batch into "
                         f"equal slices; batch rows {sorted(rows)}")
    size = next(iter(rows)) // n
    acc, slices = None, []
    for i in range(n):
        mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
        args = (values, mb)
        if rng is not None:
            args += (rng(i if n > 1 else None),)
        out = loss_fn(*args)
        loss, mets = out if has_aux else (out, {"loss": out})
        got = torch.autograd.grad(loss, floats, allow_unused=True)
        if acc is None:
            # made after the first backward, so a one-slice step's peak
            # (inside its backward) does not hold them
            acc = [torch.zeros_like(x, dtype=torch.float32)
                   for x in floats]
        for a, g in zip(acc, got):
            if g is not None:
                a.add_(g)
        slices.append(mets)
        del loss, got
    mets = {k: torch.stack([m[k].detach().float()
                            for m in slices]).mean(0)
            for k in slices[0]}
    return floats, [a.div_(n) for a in acc], mets


def _grad_tree(values, floats, grads):
    """``values``' tree with each float leaf's gradient (None for the
    other leaves)."""
    from repro_torch.train.optimizer import tree_map
    by_id = {id(x): g for x, g in zip(floats, grads)}
    return tree_map(lambda x: by_id.get(id(x)), values)


def _build_accumulating(spec: TrainSpec, ctx: StepContext):
    """The plain (n = 1) and microbatch (n > 1) steps: one body, the
    single-device Trainer's.  ``values``' float leaves must require a
    gradient."""
    n = spec.microbatches
    if n > 1 and spec.rng != "fold":
        raise ValueError(
            "microbatch accumulation folds a per-slice rng; "
            "rng='fold' is required")

    def train_step(values, opt_state, batch, rng=None):
        floats, got, mets = accumulate_grads(
            ctx.loss_fn, n, values, batch,
            rng if spec.rng == "fold" else None, has_aux=ctx.has_aux)
        grads = _grad_tree(values, floats, got)
        del got
        new_values, new_state, stats = ctx.apply_fn(values, opt_state,
                                                    grads)
        mets = dict(mets)
        mets.update(stats)
        return new_values, new_state, mets

    return train_step


def _build_elastic(spec: TrainSpec, ctx: StepContext):
    """Both elastic builders: the fsdp split is a spec field passed
    straight to ``make_elastic_dp_step``; registering them apart keeps
    each replaceable."""
    from repro_torch.dist import compression
    return compression.make_elastic_dp_step(
        ctx.loss_fn, ctx.mesh, spec.compression,
        accum_shards=spec.accum_shards, has_aux=ctx.has_aux,
        with_rng=spec.rng == "fold", apply_fn=ctx.apply_fn,
        fsdp=spec.fsdp, overlap=spec.overlap, shapes=ctx.shapes)


register_step_builder(
    "plain",
    lambda s: not s.elastic and s.microbatches == 1,
    _build_accumulating, front=False)
register_step_builder(
    "microbatch",
    lambda s: not s.elastic and s.microbatches > 1,
    _build_accumulating, front=False)
register_step_builder(
    "elastic-dp",
    lambda s: s.elastic and not s.fsdp,
    _build_elastic, front=False)
register_step_builder(
    "elastic-fsdp",
    lambda s: s.elastic and s.fsdp,
    _build_elastic, front=False)


# ------------------------------------------------------- layout facade
def dp_degree(mesh) -> int:
    """The mesh's data-parallel degree D."""
    from repro_torch.dist import compression
    return compression.dp_shard_count(mesh)


def zeros_error_state(spec: TrainSpec, values, mesh):
    """Fresh error-feedback state of an elastic spec: [V, ...] fp32 a
    float leaf, [V, 0] otherwise."""
    from repro_torch.dist import compression
    return compression.zeros_error_state(values,
                                         spec.resolve_accum(mesh))


def error_state_shapes(spec: TrainSpec, mesh):
    """``values -> the error state's shapes``, as tensors on the
    ``meta`` device (no memory): the shape-only surface."""
    from repro_torch.dist import compression
    from repro_torch.train.optimizer import tree_map
    V = spec.resolve_accum(mesh)

    def err_shapes(values):
        return compression.zeros_error_state(
            tree_map(lambda v: v.to("meta"), values), V)
    return err_shapes


def state_shardings(spec: TrainSpec, tree, mesh):
    """The placement-spec tree of params/moments under this spec: fsdp
    row-shards the V-divisible float leaves, everything else (every leaf
    of a non-fsdp spec) is replicated, ``()``."""
    from repro_torch.dist import compression
    from repro_torch.train.optimizer import tree_map
    if spec.elastic and spec.fsdp:
        return compression.fsdp_partition_specs(
            tree, mesh, spec.resolve_accum(mesh))
    return tree_map(lambda _: (), tree)


def payload_metrics(spec: TrainSpec, values, mesh) -> dict:
    """The exchange's accounting of one step, as logged in the Trainer's
    history rows:

      payload_bytes        compressed bytes ONE virtual shard ships
      exchange_fraction    against the uncompressed fp32 payload
      exchange_shards      V
      exchange_fsdp        0/1
      exchange_wire_bytes  bytes a device puts through the payload
                           collective a step: the fsdp ordered
                           reduce-scatter ships payload x rounds, the dp
                           all-gather payload x V
    """
    from repro_torch.dist import compression
    V = spec.resolve_accum(mesh)
    D = compression.dp_shard_count(mesh)
    pb = compression.payload_bytes(values, spec.compression)
    full = compression.payload_bytes(values, "none")
    return {
        "payload_bytes": int(pb),
        "exchange_fraction": float(pb / full) if full else 0.0,
        "exchange_shards": int(V),
        "exchange_fsdp": int(bool(spec.fsdp)),
        "exchange_wire_bytes": int(pb * (V // D if spec.fsdp else V)),
    }
