"""collective_ms: device ms a batch in NCCL's kernels on rank 0's card, from
the traced slice: the cross-shard merge's all-gather, its transfer and rank
0's wait in it for the slowest shard."""


def read(ctx):
    tr = ctx["trace"]
    return 1e3 * tr["collective_s"] / tr["batches"] if tr and tr.get("collective_s", 0) > 0 else None
