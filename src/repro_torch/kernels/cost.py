"""The least work of each hand-written kernel, from its shapes: the bytes
it must move (each input read once, each output written once) and its
operations by kind, and the time bound those give on an H100.

One definition for ``chip_smoke.py``'s bounds (``bound``, ``bound_of``,
``train_kernel_work``, ``topk_work``) and the dry run's tally
(``launch/dryrun.py`` through ``dist/tally.py``), which reads each
kernel op's ``op_cost``: its floating-point operations by dtype, its
bytes and the scratch its real call allocates on the card.

Rates (NVIDIA H100 SXM5 80GB data sheet, 700 W): HBM3 3.35 TB/s; fp32
outside the tensor cores 67 TFLOP/s, which counts an FMA as 2 flops
(132 SMs x 128 lanes x 2 x 1.98 GHz), so plain adds and maxes issue at
half that; a lookup in a per-query table (the LUT gather) goes through
shared memory, 32 lanes per SM per clock: a quarter of the add rate.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FADD_PER_S = 67e12 / 2
LOOKUP_PER_S = 67e12 / 8


def bound(bytes_, ops):
    """(bound ms, bound_by): bytes over HBM against each operation type
    over its own rate (``ops``: {name: (count, rate)})."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = max([n / r * 1e3 for n, r in ops.values()], default=0.0)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def bound_of(bytes_, adds, lookups):
    """(bound ms, bound_by, (bytes ms, adds ms, lookups ms)) of a top-k
    sweep: its bytes over HBM against its fp32 adds and its LUT lookups,
    each over its own rate."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_adds = adds / FADD_PER_S * 1e3
    t_lookups = lookups / LOOKUP_PER_S * 1e3
    t_ops = max(t_adds, t_lookups)
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations",
            (t_bytes, t_adds, t_lookups))


def train_kernel_work(T, N, m, b, dk, code_bytes=1):
    """The least work of each training kernel at T positions over N code
    rows of m codes, b centroids of dk floats a split: {name: (bytes,
    {op type: (count, rate)})}, inputs read once and outputs written
    once."""
    lut_b, out_b = T * m * b * 4, T * N * 4
    # the ids, the code rows they name, the centroids, the output
    look_b = T * 8 + T * m * code_bytes + m * b * dk * 4 + T * m * dk * 4
    return {
        "jpq_scores": (N * m * code_bytes + lut_b + out_b,
                       {"LUT lookups": (T * N * m, LOOKUP_PER_S),
                        "fp32 adds": (T * N * (m - 1), FADD_PER_S)}),
        "jpq_scores_bwd": (out_b + N * m * code_bytes + lut_b,
                           {"histogram updates": (T * N * m, LOOKUP_PER_S),
                            "fp32 adds": (T * N * m, FADD_PER_S)}),
        "jpq_lookup": (look_b, {}),
        "jpq_lookup_bwd": (look_b, {"fp32 adds": (T * m * dk, FADD_PER_S)}),
    }


def topk_work(Bq, N, k, m, b, code_bytes=1):
    """(bytes, fp32 adds, LUT lookups) of the unpruned fused top-k of
    ``Bq`` queries over N code rows: the codes and LUTs read once, the
    values and ids written once, one lookup and add a (query, item,
    split)."""
    return (N * m * code_bytes + Bq * m * b * 4 + Bq * k * 8, Bq * N * m,
            Bq * N * m)


def bag_work(n_bags, L, d, rows, weighted=True):
    """(bytes, fp32 FMAs) of the bag forward over ``rows`` distinct
    table rows: those rows, the ids (8 bytes) and weights (4) once, the
    output once."""
    return (rows * d * 4 + n_bags * L * (8 + 4 * bool(weighted))
            + n_bags * d * 4, n_bags * L * d)


def bag_backward_work(n_terms, n_bags, d, V):
    """(bytes, fp32 adds) of the bag backward of ``n_terms`` (id, bag)
    terms: the sorted positions and ids (12 bytes a term), ``dout``
    [n_bags, d] read once, ``dtable`` [V, d] written once."""
    return n_terms * 12 + n_bags * d * 4 + V * d * 4, n_terms * d


# --------------------------------------------- the kernel ops' tally costs

def _nbytes(t):
    return 0 if t is None else t.numel() * t.element_size()


def _dtype_name(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def op_cost(name: str, args, out) -> dict:
    """The tally's cost of one call of kernel op ``repro_torch::<name>``
    on ``args`` (its positional arguments, tensors or shapes of fake
    tensors alike) with result ``out``: ``{"flops": {dtype: n},
    "bytes": n, "scratch": n, "upper_bound": bool}``.  FLOPs count the
    floating-point adds and multiplies (an FMA as 2), bytes the least
    traffic above, scratch the buffers the card's call allocates besides
    its outputs (0 on the CPU, whose plain versions are not the
    kernels).  ``upper_bound``: the work depends on the data and the
    count is the most it could be (the pruned sweep's full sweep)."""
    return _COSTS[name](args, out)


def _cuda(t) -> bool:
    return t.device.type == "cuda"


def _scores(args, out):
    partial, codes = args[:2]
    T, m, b = partial.shape
    N = codes.shape[0]
    w = train_kernel_work(T, N, m, b, 1, codes.element_size())["jpq_scores"]
    return {"flops": {_dtype_name(partial): T * N * (m - 1)},
            "bytes": w[0], "scratch": 0}


def _scores_bwd(args, out):
    dS, codes, b = args[:3]
    T, N = dS.shape
    m = codes.shape[1]
    scratch = 0
    if _cuda(dS):
        from repro_torch.kernels.jpq_scores import cuda as sc
        n_tiles = -(-N // sc.BWD_TILE)
        fs = -(-(m * b) // sc.BWD_BINS) * sc.BWD_BINS + 8
        scratch = n_tiles * (m * sc.BWD_TILE + fs) * 2
        chunks = sc.bwd_chunks(T, m, b, N, dS.device)
        if chunks > 1:
            scratch += T * chunks * m * b * 4
    w = train_kernel_work(T, N, m, b, 1, codes.element_size())
    return {"flops": {_dtype_name(dS): T * N * m},
            "bytes": w["jpq_scores_bwd"][0], "scratch": scratch}


def _lookup(args, out):
    ids, codes, cent = args[:3]
    m, b, dk = cent.shape
    T = ids.shape[0]
    w = train_kernel_work(T, codes.shape[0], m, b, dk, codes.element_size())
    return {"flops": {}, "bytes": w["jpq_lookup"][0], "scratch": 0}


def _lookup_bwd(args, out):
    ids, codes, dout, b = args[:4]
    T, m, dk = dout.shape
    w = train_kernel_work(T, codes.shape[0], m, b, dk, codes.element_size())
    return {"flops": {_dtype_name(dout): T * m * dk},
            "bytes": w["jpq_lookup_bwd"][0], "scratch": 0}


def _topk(args, out):
    partial, codes, k = args[:3]
    B, m, b = partial.shape
    N = codes.shape[0]
    bytes_, adds, _ = topk_work(B, N, k, m, b, codes.element_size())
    scratch = 0
    if _cuda(partial):
        from repro_torch.kernels.jpq_topk import cuda as kc
        scratch = B * kc.range_count(B, N, k, m, b, partial.device,
                                     args[3]) * k * 8
    return {"flops": {_dtype_name(partial): adds}, "bytes": bytes_,
            "scratch": scratch}


def _topk_pruned(args, out):
    partial, codes, ids, present = args[:4]
    k = args[7]
    B, m, b = partial.shape
    N = codes.shape[0]
    nt = present.shape[0]
    bytes_, adds, _ = topk_work(B, N, k, m, b, codes.element_size())
    # the full sweep, plus every tile's bound (its LUT reads and max/add)
    adds += B * nt * m * (b + 1)
    bytes_ += N * 4 + nt * m * b * 4 + B * 4
    return {"flops": {_dtype_name(partial): adds}, "bytes": bytes_,
            "scratch": 0, "upper_bound": True}


def _bag(args, out):
    table, ids, weights = args[:3]
    n_bags, L = ids.shape
    d = table.shape[1]
    # every slot may name a row of its own: the most rows it can read
    bytes_, fmas = bag_work(n_bags, L, d, min(n_bags * L, table.shape[0]),
                            weights is not None)
    return {"flops": {_dtype_name(out[0]): 2 * fmas}, "bytes": bytes_,
            "scratch": 0}


def _sort_ids(args, out):
    ids = args[0]
    P = ids.numel()
    scratch = 0
    if _cuda(ids):
        # keys [2P] int32, positions [P], and CUB's radix-sort temp,
        # about a keys-and-values double buffer
        scratch = 2 * P * 4 + P * 4 + 2 * P * 8
    return {"flops": {}, "bytes": _nbytes(ids) + sum(map(_nbytes, out)),
            "scratch": scratch}


def _bag_backward(args, out):
    ids, weights, dout, V = args[:4]
    n_terms = ids.numel()
    d = dout.shape[-1]
    n_bags = dout.numel() // max(d, 1)
    bytes_, adds = bag_backward_work(n_terms, n_bags, d, V)
    flops = adds * (2 if weights is not None else 1)
    return {"flops": {_dtype_name(out): flops}, "bytes": bytes_,
            "scratch": 0}


_COSTS = {
    "jpq_scores": _scores, "jpq_scores_bwd": _scores_bwd,
    "jpq_lookup": _lookup, "jpq_lookup_bwd": _lookup_bwd,
    "jpq_topk": _topk, "jpq_topk_pruned": _topk_pruned,
    "embedding_bag": _bag, "bag_sort_ids": _sort_ids,
    "bag_backward": _bag_backward,
}
