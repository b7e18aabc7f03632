"""Table lookups with the semantics the step relies on.

Ids outside ``[0, K)`` give zero rows (a missing neighbour lane is -1, and
torch's ``t[-1]`` would silently read the last row instead); ties in
nearest-K selection go to the first index.
"""
import torch


def _in_range(idx, k):
    return (idx >= 0) & (idx < k)


def table_lookup(table, sidx, idx):
    """Rows of a stacked per-scenario table.

    table: [S, K, F]; sidx: [E]; idx: [E] or [E, N]. Entries of idx outside
    [0, K) give zero rows. Returns [*idx.shape, F].
    """
    K = table.shape[1]
    s = sidx if idx.dim() == 1 else sidx[:, None]
    rows = table[s.long(), idx.clamp(0, K - 1).long()]
    return torch.where(_in_range(idx, K)[..., None], rows, 0.0)


def onehot_pick(values, idx):
    """values [E, K] (per-env rows); idx [E] -> [E], 0 where idx is outside
    [0, K)."""
    K = values.shape[-1]
    picked = values.gather(-1, idx.clamp(0, K - 1).long()[..., None])[..., 0]
    return torch.where(_in_range(idx, K), picked, torch.zeros_like(picked))


def vector_lookup(vec, idx):
    """vec [K] or [K, F] static table; idx [...] -> [...] or [..., F], zero
    where idx is outside [0, K)."""
    K = vec.shape[0]
    rows = vec[idx.clamp(0, K - 1).long()]
    ok = _in_range(idx, K)
    if vec.dim() > 1:
        ok = ok[..., None]
    return torch.where(ok, rows, torch.zeros_like(rows))


def nearest_k_index(dist, k):
    """K rounds of min-reduce with a first-index tie break over the last axis.

    dist [..., N] (inf = invalid). Returns (idx [..., K] int64, found
    [..., K] bool); where found is False the index is 0 and means nothing.
    """
    idxs, founds = [], []
    d = dist
    for _ in range(k):
        first = d.argmin(dim=-1)   # torch.argmin returns the first minimum
        found = torch.isfinite(d.amin(dim=-1))
        idxs.append(first)
        founds.append(found)
        d = d.scatter(-1, first[..., None], torch.inf)
    return torch.stack(idxs, dim=-1), torch.stack(founds, dim=-1)


def nearest_k_onehot(dist, k):
    """`nearest_k_index` as (sel [..., K, N] float one-hot rows, found
    [..., K] bool); a row that found nothing is all zeros."""
    idx, found = nearest_k_index(dist, k)
    slots = torch.arange(dist.shape[-1], device=dist.device)
    return ((idx[..., None] == slots) & found[..., None]).float(), found
