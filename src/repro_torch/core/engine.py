"""The retrieval engine: one declarative spec, one scorer registry.

* ``RetrievalSpec`` — a frozen, hashable description of how to serve
  (embedding kind, fused/materialise, tile size, prune/perm/warm
  policies, k, stats); it keys ``JitCache``.  Which backend runs is
  not a policy: the tensors' device decides it (the hand-written kernel
  on ``cuda``, its plain version on the CPU), so ``backend=None`` is the
  only value ``spec_for`` and ``core/serve.retrieve_topk`` take.
* a scorer registry — ``register_scorer(name, match, fn)`` entries
  claimed by the spec; the built-ins are materialise-then-top-k, JPQ
  fused, JPQ fused-pruned and JPQ pruned with a permutation or a warm
  floor, and ``core/semantic.py`` registers the semantic-ID head.
* ``RetrievalEngine`` — binds (spec, embedding, params) and optionally a
  catalogue version (the ``PruneState``), and serves
  ``engine.retrieve(h, floor=...)``; ``BoundRetrieval`` adds the model's
  request encoder (``TwoTower.bind_engine`` returns one).
* ``add_spec_args`` / ``spec_from_args`` — the serving CLIs' shared flag
  cluster; ``spec_for`` — the kwargs -> spec normaliser.

The engine only routes: every strategy calls ``sharded.*``, which ends
in the kernels (CUDA tensors) or their plain versions (CPU tensors).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

from repro_torch.core import jpq as _jpq
from repro_torch.core import sharded
from repro_torch.kernels.jpq_topk import ops as _tops


# ===================================================================== spec

@dataclasses.dataclass(frozen=True)
class RetrievalSpec:
    """Frozen, hashable description of a retrieval configuration.

    Fields are policy, not runtime state: ``prune`` says "serve pruned"
    while the ``PruneState`` is bound on the engine per catalogue
    version; ``warm`` is the EMA decay of the floor policy while the
    per-request floor is an argument; ``perm`` names the sweep order
    ("none" / "popularity" / "catalogue")."""
    kind: str = "jpq"
    k: int = 10
    fused: bool = True
    block_n: Optional[int] = None
    prune: bool = False
    perm: str = "none"
    warm: Optional[float] = None
    stats: bool = False
    beams: Optional[int] = None

    def __post_init__(self):
        if not isinstance(self.kind, str) or not self.kind:
            raise ValueError(f"spec kind must be a non-empty string, "
                             f"got {self.kind!r}")
        if int(self.k) < 1:
            raise ValueError(f"spec k must be >= 1, got {self.k}")
        if self.block_n is not None and int(self.block_n) < 1:
            raise ValueError(f"spec block_n must be a positive int or "
                             f"None, got {self.block_n!r}")
        if self.perm != "none" and not self.prune:
            raise ValueError(
                f"perm={self.perm!r} is a pruned-path policy: permuted "
                f"sweeps exist to tighten the pruning threshold early — "
                f"set prune=True or perm='none'")
        if self.warm is not None:
            if not (self.prune and self.fused):
                raise ValueError(
                    "warm floors are a pruned-fused-path feature: the "
                    "floor seeds the pruning threshold, which only "
                    "exists on the fused pruned sweep — set prune=True "
                    "and fused=True, or warm=None")
            if not 0.0 <= float(self.warm) < 1.0:
                raise ValueError(
                    f"warm (EMA decay) must be in [0, 1): {self.warm} "
                    f"(1.0 would freeze the EMA at its first value)")
        if self.stats and not (self.prune and self.fused):
            raise ValueError(
                "stats are a pruned-fused-path feature (skip counts and "
                "the final threshold theta only exist on the pruned "
                "sweep) — set prune=True and fused=True, or stats=False")
        if self.beams is not None and int(self.beams) < 1:
            raise ValueError(
                f"spec beams must be a positive int or None (auto), "
                f"got {self.beams!r}")


def spec_for(emb_or_kind, *, k: int, fused: bool = True,
             block_n: Optional[int] = None, backend=None,
             prune=None, perm=None, warm_decay: Optional[float] = None,
             stats: bool = False) -> RetrievalSpec:
    """Normalise ``retrieve_topk``-style kwargs into a spec: ``prune`` /
    ``perm`` drop silently where the path cannot honour them (non-JPQ
    kind or ``fused=False``); an undeliverable warm policy raises.
    ``backend`` is the reference's Pallas route ("pallas", "interpret",
    "scan"); the port has none, so None is its only value and any other
    raises."""
    if backend is not None:
        raise ValueError(
            f"backend={backend!r}: repro_torch has no backend switch — "
            f"the tensors' device picks the route (the hand-written "
            f"kernel on cuda, its plain PyTorch version on the CPU); "
            f"pass backend=None")
    kind = emb_or_kind if isinstance(emb_or_kind, str) \
        else emb_or_kind.cfg.kind
    supports_prune = bool(fused) and kind == "jpq"
    pruned = bool(prune) and supports_prune
    if warm_decay is not None and not pruned:
        raise ValueError(
            "warm floors are pruned-JPQ-fused-path features: this "
            "path has no pruning threshold to seed — serve "
            "kind='jpq' with fused=True and prune=True, or drop the "
            "warm policy")
    return RetrievalSpec(
        kind=kind, k=int(k), fused=bool(fused), block_n=block_n,
        prune=pruned,
        perm="popularity" if (pruned and perm is not None) else "none",
        warm=warm_decay if pruned else None, stats=bool(stats))


# ================================================== flag cluster (CLIs)

def add_spec_args(ap, *, fused_default: bool = True,
                  prune_default: bool = False,
                  perm_default: bool = False) -> None:
    """Register the shared retrieval flag cluster (the reference's
    flags, same names and defaults)."""
    import argparse
    ap.add_argument("--fused", action=argparse.BooleanOptionalAction,
                    default=fused_default,
                    help="fused PQTopK serve path for retrieval archs "
                         "(--no-fused: materialise-then-top-k reference)")
    ap.add_argument("--prune", action=argparse.BooleanOptionalAction,
                    default=prune_default,
                    help="score-bound dynamic pruning of code tiles on "
                         "the fused path (exact)")
    ap.add_argument("--perm", action=argparse.BooleanOptionalAction,
                    default=perm_default,
                    help="popularity-permuted pruned sweep")
    ap.add_argument("--warm", "--warm-theta", dest="warm", nargs="?",
                    const=0.9, default=None, type=float, metavar="DECAY",
                    help="EMA warm-start of the pruning threshold "
                         "(core.serve.ThresholdState; default decay 0.9)")
    ap.add_argument("--head", choices=("score", "semantic"),
                    default="score",
                    help="retrieval head: 'score' sweeps the catalogue "
                         "(fused/materialise per the flags above); "
                         "'semantic' decodes items as their m-token "
                         "code sequences (constrained beam search; needs "
                         "a JPQ embedding)")
    ap.add_argument("--beams", type=int, default=None, metavar="W",
                    help="semantic-head beam width (default: max(32, "
                         "4*k), capped at the trie's path count; beams "
                         ">= n_paths is exhaustive and bit-matches the "
                         "materialise scorer)")


def spec_from_args(args, *, kind: str = "jpq", k: Optional[int] = None,
                   stats: Optional[bool] = None) -> RetrievalSpec:
    """Resolve the ``add_spec_args`` flag cluster into a RetrievalSpec.
    A non-JPQ kind or ``--no-fused`` drops prune (and with it perm and
    warm); ``stats`` defaults to "on iff pruned".  ``--head semantic``
    makes the kind "semantic", which needs a JPQ embedding underneath
    (its trie is built from the codes), so another base kind raises."""
    if getattr(args, "head", "score") == "semantic":
        if kind != "jpq":
            raise ValueError(
                f"--head semantic decodes JPQ code sequences, so it "
                f"needs a JPQ item embedding — the model's embedding "
                f"kind is {kind!r}")
        kind = "semantic"
    fused = bool(getattr(args, "fused", True))
    prune = bool(getattr(args, "prune", False)) and fused and kind == "jpq"
    perm = "popularity" if (bool(getattr(args, "perm", False)) and prune) \
        else "none"
    warm = getattr(args, "warm", None)
    warm = float(warm) if (warm is not None and prune) else None
    if k is None:
        k = int(getattr(args, "top_k", 10))
    if stats is None:
        stats = prune
    beams = getattr(args, "beams", None)
    return RetrievalSpec(kind=kind, k=int(k), fused=fused, prune=prune,
                         perm=perm, warm=warm, stats=bool(stats),
                         beams=None if beams is None else int(beams))


# ============================================================ registry

# (name, match(spec) -> bool, scorer(engine, params, h, floor)); the
# first match wins, and new registrations go to the front
_SCORERS: List[Tuple[str, Callable, Callable]] = []


def register_scorer(name: str, match: Callable[[RetrievalSpec], bool],
                    fn: Callable, *, front: bool = True) -> None:
    """Add a scoring strategy.  ``fn(engine, params, h, floor)`` scores a
    [B, d] query block and returns ``(values, ids)`` — plus the stats
    dict when ``spec.stats``."""
    entry = (str(name), match, fn)
    if front:
        _SCORERS.insert(0, entry)
    else:
        _SCORERS.append(entry)


def unregister_scorer(name: str) -> None:
    _SCORERS[:] = [e for e in _SCORERS if e[0] != name]


def scorer_names() -> Tuple[str, ...]:
    return tuple(e[0] for e in _SCORERS)


def resolve_scorer(spec: RetrievalSpec) -> Tuple[str, Callable]:
    for name, match, fn in _SCORERS:
        if match(spec):
            return name, fn
    raise ValueError(
        f"no scorer strategy matches {spec} — registered: "
        f"{scorer_names()}; register one with "
        f"core.engine.register_scorer(name, match, fn)")


# =========================================================== strategies

def _materialise_scorer(engine, p, h, floor):
    """full (or ``fused=False``) reference: materialise [B, N] scores,
    then an exact top-k."""
    spec = engine.spec
    if spec.prune or engine.prune is not None:
        raise ValueError(
            f"pruning is a fused-JPQ-path feature (it skips CODE tiles); "
            f"spec {spec} materialises the score matrix — use "
            f"kind='jpq' with fused=True, or drop the prune policy")
    if floor is not None:
        raise ValueError(
            "warm floors / stats are pruned-JPQ-fused-path features: "
            "the materialise path has no pruning threshold to seed — "
            "serve with kind='jpq', fused=True and a prune policy, or "
            "drop the floor")
    # under a "model" mesh the parameters hold this rank's rows, so
    # these are its own column block of the scores (the reference's
    # constrain(scores, ("batch", "items")))
    scores = engine.emb.logits(p, h)                       # [B, N(/S)]
    return sharded.topk_over_items(scores, int(spec.k),
                                   rows=_catalogue_rows(engine))


def _jpq_fused_scorer(engine, p, h, floor):
    """JPQ fused PQTopK: the partial-score LUT against the codes with a
    running top-k — pruned (+permuted/warm) when the engine carries
    pruning state."""
    spec = engine.spec
    part = _jpq.partial_scores(p, h)                       # [B, m, b]
    return sharded.fused_topk_over_codes(
        part, p["codes"], spec.k, block_n=spec.block_n, prune=engine.prune,
        perm=engine.perm, warm=floor, return_stats=spec.stats,
        rows=_catalogue_rows(engine))


def _catalogue_rows(engine):
    """The catalogue's row count (the operand may hold a rank's block)."""
    return None if engine.emb is None else int(engine.emb.cfg.n_items)


register_scorer(
    "materialise",
    lambda s: not s.fused or s.kind != "jpq",
    _materialise_scorer, front=False)
register_scorer(
    "jpq-fused",
    lambda s: s.fused and s.kind == "jpq" and not s.prune,
    _jpq_fused_scorer, front=False)
register_scorer(
    "jpq-fused-pruned",
    lambda s: (s.fused and s.kind == "jpq" and s.prune
               and s.perm == "none" and s.warm is None),
    _jpq_fused_scorer, front=False)
register_scorer(
    "jpq-pruned-permuted-warm",
    lambda s: (s.fused and s.kind == "jpq" and s.prune
               and (s.perm != "none" or s.warm is not None)),
    _jpq_fused_scorer, front=False)


# ============================================================== engine

class RetrievalEngine:
    """Binds (spec, embedding, params) once; resolves the scorer once.
    ``bind_catalogue`` attaches a catalogue version's pruning state
    (``True`` builds it inline per request) and permutation."""

    def __init__(self, spec: RetrievalSpec, emb=None, params=None, *,
                 catalogue=None):
        self.spec = spec
        self.emb = emb
        self.params = params
        self.strategy, self._scorer = resolve_scorer(spec)
        self.prune = True if spec.prune else None
        self.perm = None
        self.version = 0
        if catalogue is not None:
            self.bind_catalogue(catalogue)

    def bind_catalogue(self, catalogue=None, *, prune=None, perm=None,
                       version: int = 0) -> "RetrievalEngine":
        """Attach a catalogue version: ``catalogue`` duck-types an object
        with ``.state`` / ``.version`` (a prebuilt state embeds its
        permutation), or pass ``prune=`` / ``perm=`` directly."""
        if catalogue is not None:
            prune = getattr(catalogue, "state", None)
            version = getattr(catalogue, "version", version)
            perm = None
        if self.spec.prune:
            self.prune = True if prune is None else prune
        else:
            if prune not in (None, False):
                raise ValueError(
                    f"spec {self.spec} declares prune=False but a "
                    f"pruning state was bound — the spec is the cache "
                    f"key, so state and policy must agree")
            self.prune = None
            perm = None
        self.perm = perm
        self.version = int(version)
        return self

    def retrieve(self, h, *, params=None, floor=None):
        """h [..., d] query vectors -> (values, ids) [..., min(k, N)]
        (+ the pruning-stats dict when ``spec.stats``)."""
        p = self.params if params is None else params
        lead = h.shape[:-1]
        out = self._scorer(self, p, h.reshape(-1, h.shape[-1]), floor)
        if self.spec.stats:
            v, i, stats = out
            return v.reshape(*lead, -1), i.reshape(*lead, -1), stats
        v, i = out
        return v.reshape(*lead, -1), i.reshape(*lead, -1)


class BoundRetrieval:
    """Model-level engine binding: raw request -> results.  ``encode``
    maps the request to [B, d] query vectors; ``postprocess`` applies
    model-protocol fix-ups."""

    def __init__(self, engine: RetrievalEngine, encode: Callable,
                 postprocess: Optional[Callable] = None):
        self.engine = engine
        self._encode = encode
        self._post = postprocess

    @property
    def spec(self) -> RetrievalSpec:
        return self.engine.spec

    def retrieve(self, request, *, floor=None):
        out = self.engine.retrieve(self._encode(request), floor=floor)
        return out if self._post is None else self._post(out)


class JitCache:
    """Cache of bound serving callables keyed on ``(spec, catalogue
    version, bucket_len)``; ``evict`` drops retired catalogue versions
    on hot-swap.  PyTorch runs eagerly, so an entry is the bound
    callable itself."""

    def __init__(self):
        self._fns = {}

    @staticmethod
    def key(spec: RetrievalSpec, version: int, bucket_len: int):
        if not isinstance(spec, RetrievalSpec):
            raise TypeError(f"cache keys on RetrievalSpec, got "
                            f"{type(spec).__name__}")
        return (spec, int(version), int(bucket_len))

    def get(self, spec: RetrievalSpec, version: int, bucket_len: int,
            build: Callable[[], Callable]) -> Callable:
        key = self.key(spec, version, bucket_len)
        fn = self._fns.get(key)
        if fn is None:
            fn = self._fns[key] = build()
        return fn

    def evict(self, keep_versions) -> int:
        keep = {int(v) for v in keep_versions}
        dead = [k for k in self._fns if k[1] not in keep]
        for k in dead:
            del self._fns[k]
        return len(dead)

    def versions(self) -> Tuple[int, ...]:
        return tuple(sorted({k[1] for k in self._fns}))

    def __len__(self) -> int:
        return len(self._fns)

    def __contains__(self, key) -> bool:
        return key in self._fns


# ==================================== catalogue-prep / protocol helpers

def resolve_prune_block_n(N: int, *, shards: int = 0,
                          block_n: Optional[int] = None) -> int:
    """Tile size for a pruning state: an explicit ``block_n`` wins;
    under an S-way mesh whose shards tile N, ``mesh_prune_block_n``
    keeps one global state row-sliceable; otherwise
    ``prune_block_n(N)``."""
    if block_n:
        return int(block_n)
    if shards and int(shards) > 1 and N % int(shards) == 0:
        return _tops.mesh_prune_block_n(N, int(shards))
    return _tops.prune_block_n(N)


def build_prune_state(codes, b: int, *, shards: int = 0,
                      block_n: Optional[int] = None, perm=None):
    """Build the codes-only presence-mask state once, outside the
    per-request path.  ``perm``: optional [N] sweep order, baked into
    the state (permute-then-shard under a mesh).  ``codes`` is the
    whole catalogue: every rank of a mesh holds the global state and
    serves its slice of it."""
    bn = resolve_prune_block_n(codes.shape[0], shards=shards,
                               block_n=block_n)
    return _tops.prepare_pruning(codes, int(b), bn, perm=perm)


def probe_topk(partial, codes, k: int, *, prune=None):
    """Unsharded fused top-k over a probe LUT (catalogue swap checks)."""
    return _tops.jpq_topk_lut(partial, codes, k, prune=prune)


def rerank_candidates(values, ids, k: int):
    """Stable (value desc, id asc) re-rank of a candidate list,
    truncated to k — the ``lax.top_k`` total order, ±0.0 included."""
    k = min(int(k), values.shape[-1])
    return _tops.topk_desc(values, ids, k)
