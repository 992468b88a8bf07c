"""The JAX package's side of ``test_torch_train_dist.py``, on eight host
devices (run with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``).

    python tests/torch_train_dist_ref.py OUT.npz [PART ...]

Writes the named parts (``PARTS``; all of them by default), from numpy
seeds shared with ``torch_train_dist_worker.py``:

* ``shard/<i>``: ``NamedSharding(mesh, spec).devices_indices_map`` of
  ``SHARD_CASES[i]`` on a (pod 2, data 2, model 2) mesh, as [8, ndim, 2]
  (start, stop) in the mesh's device order;
* ``psum/<round>/<leaf>/mean|resid``: ``compressed_psum`` under
  ``shard_map`` over four devices, two rounds (the second from the first's
  residual), stacked over the ranks;
* ``dp/<compress>``: eight losses of ``make_dp_train_step`` on the f32
  SMOKE llama3.2-1b over four devices (data 4, model 1), from
  ``init_params(cfg, PRNGKey(0))``;
* ``elastic/w``: the toy quadratic's final ``w`` after ``ElasticRunner``
  went from four devices to two at step 17;
* ``fsdp/<arch>/<layout>/metrics`` and ``.../param<keystr>``: the loss,
  grad norm and final parameters of ``make_train_step`` jitted with
  ``in_shardings`` from ``param_specs`` / ``opt_state_specs`` /
  ``batch_spec`` (GSPMD, as ``launch/train.py`` runs it) on a (data 2,
  model 2), a (pod 2, data 2, model 1) and a (data 1, model 4) mesh of
  four devices,
  ``FSDP_STEPS`` steps of the f32 SMOKE config from ``init_params(cfg,
  PRNGKey(0))``;
* ``serve/<arch>/<layout>``: the logits of ``prefill_step`` and
  ``SERVE_NEW`` ``decode_step``s jitted with ``in_shardings`` from
  ``param_specs`` / ``cache_specs`` / ``batch_spec`` (as the reference's
  dry-run lowers them) on the meshes of ``SERVE_LAYOUTS``, from the same
  parameters over ``serve_tokens``, [1 + SERVE_NEW, B, (K,) V];
* ``<name>/metrics`` and ``<name>/prefill`` for each of ``SCAN_CASES``
  (the f32 SMOKE config with the case's changes) on the (data 1, model 4)
  mesh: one ``make_train_step`` and the ``prefill_step`` of
  ``serve_tokens``' first ``SERVE_PROMPT`` positions, jitted with
  ``in_shardings`` as above, from the arch's ``init_params(cfg,
  PRNGKey(0))``.
"""
import dataclasses
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from repro.configs import get_config
from repro.distributed.compat import shard_map
from repro.distributed.compression import compressed_psum
from repro.distributed.elastic import ElasticRunner
from repro.distributed.sharding import (batch_spec, cache_specs, logits_spec, opt_state_specs,
                                       param_specs)
from repro.models import (decode_step, init_decode_state, init_params, make_train_step,
                          prefill_step)
from repro.train import CheckpointManager, adamw
from repro.train.dp_trainer import make_dp_train_step

import torch_train_dist_worker as case


def shard_maps(out):
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2), ("pod", "data", "model"))
    for i, (shape, spec) in enumerate(case.SHARD_CASES):
        idx = NamedSharding(mesh, P(*spec)).devices_indices_map(shape)
        rows = []
        for dev in mesh.devices.flat:
            rows.append([[s.start or 0, s.stop if s.stop is not None else n]
                         for s, n in zip(idx[dev], shape)])
        out[f"shard/{i}"] = np.array(rows, np.int64)


def psum(out):
    mesh = Mesh(np.array(jax.devices()[:case.WORLD]), ("data",))
    grads, resid = case.psum_inputs()
    fn = jax.jit(shard_map(lambda g, r: compressed_psum(g, r, "data"), mesh,
                           (P("data"), P("data")), (P("data"), P("data"))))
    g = {k: jnp.asarray(v.reshape((-1,) + v.shape[2:])) for k, v in grads.items()}
    r = {k: jnp.asarray(v.reshape((-1,) + v.shape[2:])) for k, v in resid.items()}
    for rnd in range(2):
        means, r = fn(g, r)
        for k in g:
            out[f"psum/{rnd}/{k}/mean"] = np.asarray(means[k]).reshape(grads[k].shape)
            out[f"psum/{rnd}/{k}/resid"] = np.asarray(r[k]).reshape(grads[k].shape)


def dp(out):
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True), dtype="float32")
    mesh = Mesh(np.array(jax.devices()[:case.WORLD]).reshape(case.WORLD, 1), ("data", "model"))
    batch = case.dp_batch(cfg)
    for compress in (False, True):
        params = init_params(cfg, jax.random.PRNGKey(0))
        init_state, step = make_dp_train_step(cfg, adamw(lr=case.DP_LR), mesh,
                                              compress_grads=compress)
        # f32 masters alias the f32 parameters (astype to the same dtype),
        # and the jitted step donates both: copy every leaf first
        state = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), init_state(params))
        losses = []
        for _ in range(case.DP_STEPS):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        out[f"dp/{int(compress)}"] = np.array(losses)


def elastic(out):
    opt = adamw(lr=0.1, weight_decay=0.0)

    def make_step(mesh):
        def step(state, batch):
            def loss_fn(p):
                return jnp.mean((batch["x"] @ p["w"] - batch["y"]) ** 2)
            g = jax.grad(loss_fn)(state["params"])
            new_p, new_o, _ = opt.update(g, state["opt"], state["params"])
            return {"params": new_p, "opt": new_o}
        return jax.jit(step)

    def state_specs(mesh):
        return jax.tree_util.tree_map(lambda _: P(),
                                      {"params": {"w": 0}, "opt": opt.init({"w": jnp.zeros((4,))})})

    w0, batches = case.elastic_inputs()
    w0 = {"w": jnp.asarray(w0)}
    state = {"params": w0, "opt": opt.init(w0)}
    with tempfile.TemporaryDirectory() as d:
        runner = ElasticRunner(ckpt=CheckpointManager(d, keep=2),
                               make_mesh=lambda n: jax.make_mesh((n,), ("data",)),
                               make_step=make_step, state_specs=state_specs, ckpt_every=5)
        state, steps, restarts = runner.run(state, batches, n_devices=case.WORLD,
                                            fail_at=case.FAIL_AT, recover_devices=case.WORLD // 2)
    assert steps == len(batches) and restarts == 1
    out["elastic/w"] = np.asarray(state["params"]["w"])


MESH_SHAPES = {"data2_model2": ((2, 2), ("data", "model")),
               "pod2_data2": ((2, 2, 1), ("pod", "data", "model")),
               "data1_model4": ((1, 4), ("data", "model"))}


def fsdp(out):
    shapes = MESH_SHAPES
    assert set(shapes) == set(case.FSDP_LAYOUTS)
    for arch in case.FSDP_ARCHS:
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
        params = init_params(cfg, jax.random.PRNGKey(0))
        opt = adamw(lr=case.FSDP_LR)
        for layout, (shape, names) in shapes.items():
            mesh = Mesh(np.array(jax.devices()[:case.WORLD]).reshape(shape), names)
            pspecs = param_specs(params, cfg, mesh)
            ospecs = opt_state_specs(opt.init(params), pspecs)
            ns = lambda t: jax.tree_util.tree_map(lambda sp: NamedSharding(mesh, sp), t)
            bshard = NamedSharding(mesh, batch_spec(mesh, (case.FSDP_BATCH, case.FSDP_SEQ)))
            step = jax.jit(make_train_step(cfg, opt),
                           in_shardings=(ns(pspecs), ns(ospecs), {"tokens": bshard, "labels": bshard}),
                           out_shardings=(ns(pspecs), ns(ospecs), NamedSharding(mesh, P())))
            p = jax.device_put(params, ns(pspecs))
            o = jax.device_put(opt.init(params), ns(ospecs))
            metrics = []
            for batch in case.fsdp_batches(cfg):
                p, o, m = step(p, o, batch)
                metrics.append([float(m["loss"]), float(m["grad_norm"])])
            key = f"fsdp/{arch}/{layout}"
            out[f"{key}/metrics"] = np.array(metrics)
            for path, leaf in jax.tree_util.tree_flatten_with_path(p)[0]:
                out[f"{key}/param{jax.tree_util.keystr(path)}"] = np.asarray(leaf)


def _copy_prefix(dst, src, n):
    """``case.copy_prefix`` on the reference's trees, functionally."""
    out = {}
    for k, v in dst.items():
        if isinstance(v, dict):
            out[k] = _copy_prefix(v, src[k], n)
        elif k in ("k", "v"):
            out[k] = v.at[..., :n, :, :].set(src[k])
        else:
            out[k] = src[k]
    return out


def serve(out):
    S, B, new = case.SERVE_PROMPT, case.SERVE_BATCH, case.SERVE_NEW
    for arch in case.FSDP_ARCHS:
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
        params = init_params(cfg, jax.random.PRNGKey(0))
        toks = jnp.asarray(case.serve_tokens(cfg).astype(np.int32))
        vshape = (B,) + ((cfg.num_codebooks,) if cfg.num_codebooks > 1 else ()) + (cfg.vocab_size,)
        for layout in case.SERVE_LAYOUTS:
            shape, names = MESH_SHAPES[layout]
            mesh = Mesh(np.array(jax.devices()[:case.WORLD]).reshape(shape), names)
            ns = lambda t: jax.tree_util.tree_map(lambda sp: NamedSharding(mesh, sp), t)
            pspecs = param_specs(params, cfg, mesh)
            lspec = NamedSharding(mesh, logits_spec(mesh, vshape))
            prompt = toks[:, :S]
            pspec_c = cache_specs(jax.eval_shape(lambda: init_decode_state(cfg, B, S)), cfg, mesh)
            prefill = jax.jit(lambda p, t: prefill_step(p, cfg, t),
                              in_shardings=(ns(pspecs), NamedSharding(mesh, batch_spec(mesh, prompt.shape))),
                              out_shardings=(lspec, ns(pspec_c)))
            p = jax.device_put(params, ns(pspecs))
            logits, cache = prefill(p, prompt)
            state = _copy_prefix(init_decode_state(cfg, B, S + new), cache, S)
            dspecs = cache_specs(state, cfg, mesh)
            tok1 = toks[:, S:S + 1]
            decode = jax.jit(lambda p, c, t, q: decode_step(p, cfg, c, t, q),
                             in_shardings=(ns(pspecs), ns(dspecs),
                                           NamedSharding(mesh, batch_spec(mesh, tok1.shape)),
                                           NamedSharding(mesh, batch_spec(mesh, (B,)))),
                             out_shardings=(lspec, ns(dspecs)))
            state = jax.device_put(state, ns(dspecs))
            steps = [np.asarray(logits)]
            for i in range(new):
                logits, state = decode(p, state, toks[:, S + i:S + i + 1],
                                       jnp.full((B,), S + i, jnp.int32))
                steps.append(np.asarray(logits))
            out[f"serve/{arch}/{layout}"] = np.stack(steps)


def scans(out):
    shape, names = MESH_SHAPES["data1_model4"]
    mesh = Mesh(np.array(jax.devices()[:case.WORLD]).reshape(shape), names)
    ns = lambda t: jax.tree_util.tree_map(lambda sp: NamedSharding(mesh, sp), t)
    for name, (arch, changes) in case.SCAN_CASES.items():
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32", **changes)
        params = init_params(cfg, jax.random.PRNGKey(0))
        opt = adamw(lr=case.FSDP_LR)
        pspecs = param_specs(params, cfg, mesh)
        ospecs = opt_state_specs(opt.init(params), pspecs)
        bshard = NamedSharding(mesh, batch_spec(mesh, (case.FSDP_BATCH, case.FSDP_SEQ)))
        step = jax.jit(make_train_step(cfg, opt),
                       in_shardings=(ns(pspecs), ns(ospecs), {"tokens": bshard, "labels": bshard}),
                       out_shardings=(ns(pspecs), ns(ospecs), NamedSharding(mesh, P())))
        p = jax.device_put(params, ns(pspecs))
        _, _, m = step(p, jax.device_put(opt.init(params), ns(ospecs)), case.fsdp_batches(cfg)[0])
        out[f"{name}/metrics"] = np.array([float(m["loss"]), float(m["grad_norm"])])
        prompt = jnp.asarray(case.serve_tokens(cfg)[:, :case.SERVE_PROMPT].astype(np.int32))
        B, S = prompt.shape
        cspecs = cache_specs(jax.eval_shape(lambda: init_decode_state(cfg, B, S)), cfg, mesh)
        prefill = jax.jit(lambda p, t: prefill_step(p, cfg, t),
                          in_shardings=(ns(pspecs), NamedSharding(mesh, batch_spec(mesh, prompt.shape))),
                          out_shardings=(NamedSharding(mesh, logits_spec(mesh, (B, cfg.vocab_size))),
                                         ns(cspecs)))
        out[f"{name}/prefill"] = np.asarray(prefill(p, prompt)[0])


PARTS = {f.__name__: f for f in (shard_maps, psum, dp, elastic, fsdp, serve, scans)}


def main(path, parts):
    out = {}
    for name in parts or PARTS:
        PARTS[name](out)
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
