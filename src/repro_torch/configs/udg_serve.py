"""udg-serve: the serving deployment's configuration (a copy of the JAX
package's ``configs/udg_serve.py``).

One shard of the deployment: 65536 vectors of d=768 (each shard its own
UDG), padded labeled degree 96, 4096-query batches, beam 64, k 10, the
containment relation. ``merge`` is the cross-shard top-k merge of
``repro_torch.serve.serve_batch`` (the launcher's default ``--merge``);
``build_batched`` / ``build_wave`` pick the constructor
``build_sharded_index`` runs (``build_kwargs``). ``degree`` and
``vec_dtype`` describe the deployment as the reference's configuration
does; nothing in the port reads them, and the port stores f32 rows only. The
planner thresholds are the defaults ``repro_torch.exec.plan`` reads.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class UdgServeConfig:
    n_per_shard: int = 65536
    dim: int = 768
    degree: int = 96
    batch: int = 4096
    k: int = 10
    beam: int = 64
    relation: str = "containment"
    merge: str = "all_gather"      # all_gather | tournament
    vec_dtype: str = "f32"         # the port has no bf16 path
    # index (re)build strategy (repro_torch.core.build_batched); plumb through
    # build_sharded_index(..., build_kwargs=CONFIG.build_kwargs())
    build_batched: bool = True
    build_wave: int = 512          # insertion-wave width
    # --- query planner thresholds (repro_torch.exec) --------------------------
    # Per-query execution strategy from the estimated valid-set size (upper
    # bound from the rank-space histogram, resolution planner_buckets^2):
    #   hi <= planner_brute_max_valid          -> BRUTE_VALID (exact scan of
    #       the enumerated valid ids; also the static id capacity of that
    #       path, so the plan is only taken when the set provably fits)
    #   hi <= planner_wide_fraction * n        -> GRAPH_WIDE (beam *
    #       planner_wide_beam_scale, multi-expand planner_wide_expand)
    #   otherwise                               -> GRAPH
    # These defaults MUST stay numerically in sync with the PlannerConfig
    # field defaults in repro_torch/exec/plan.py.
    planner_buckets: int = 64
    planner_brute_max_valid: int = 256
    planner_wide_fraction: float = 0.05
    planner_wide_beam_scale: int = 2
    planner_wide_expand: int = 2

    def planner_config(self):
        """The ``repro_torch.exec.PlannerConfig`` implementing these
        thresholds (lazy import: the exec layer sits above configs)."""
        from repro_torch.exec.plan import PlannerConfig

        return PlannerConfig(
            buckets=self.planner_buckets,
            brute_max_valid=self.planner_brute_max_valid,
            wide_max_fraction=self.planner_wide_fraction,
            wide_beam_scale=self.planner_wide_beam_scale,
            wide_expand=self.planner_wide_expand,
        )

    def build_kwargs(self, pad_nodes: int | None = None) -> dict:
        """kwargs for ``build_udg`` implementing this config's strategy.

        ``pad_nodes`` defaults to ``n_per_shard`` (static sharded builds);
        a ``StreamingIndex`` pins its own ``pad_nodes=node_capacity``, and a
        sharded build smaller than the deployment's shard passes its own
        shard size, so that 65536-row tables do not leak into it."""
        return dict(
            batched=self.build_batched,
            wave=self.build_wave,
            pad_nodes=pad_nodes if pad_nodes is not None else self.n_per_shard,
        )


CONFIG = UdgServeConfig()
