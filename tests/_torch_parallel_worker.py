"""One rank of the port's partitioned forwards and parallel training,
spawned by ``tests/test_torch_parallel.py``,
``tests/test_torch_partitioned_train.py`` (gloo on the CPU) and
``tests/test_torch_gpu.py`` (gloo, ranks sharing the card). Imports no
JAX.

``run(rank, world, init, case_path, out_dir)`` reads the case (a pickle the
test wrote: configs, numpy params, graphs and the tasks), starts the
process group at ``init`` (``file://`` under the test's tmp_path), runs
each task and writes this rank's results to ``out_dir/rank<r>.pkl``; a
failure writes its traceback to ``out_dir/rank<r>.err`` and exits non-zero.
"""
import os
import pickle
import sys
import traceback

import numpy as np


def _np(tree):
    from nmrgnn_tpu_torch.models import gnn

    return gnn.tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _train_task(task, case, dev):
    """The training tasks: each on its own (data, graph) mesh of the world's
    ranks (every rank runs every task, in order)."""
    import torch

    from nmrgnn_tpu_torch import parallel as par
    from nmrgnn_tpu_torch.config import ModelConfig, TrainConfig
    from nmrgnn_tpu_torch.data.dataset import Sample
    from nmrgnn_tpu_torch.graph import Graph
    from nmrgnn_tpu_torch.library import params_from_numpy
    from nmrgnn_tpu_torch.models import gnn
    from nmrgnn_tpu_torch.ops import _cuda
    from nmrgnn_tpu_torch.train.trainer import TrainState, Trainer, adam

    kind = task["kind"]
    mesh = par.make_mesh(data=task.get("data", 1), graph=task.get("graph"))
    cfg = ModelConfig(**case["configs"][task["model"]])
    params = params_from_numpy(case["params"][task["model"]], device=dev)
    loss_idx = case["loss_idx"]
    use_kernels = task.get("use_kernels", True)
    if kind == "grad":  # gradients of a squared error through the partitioned forward
        g = Graph(*case["graphs"][task["graph_name"]])
        D = mesh.shape["graph"]
        plan = par.make_banded_halo_plan(g.nlist, g.edges, D)
        leaves = gnn.trainable_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        _cuda.reset_launch_counts()
        peaks = par.apply_partitioned_banded(params, cfg, g, plan, mesh, differentiable=True,
                                             use_kernels=use_kernels)
        tgt = torch.as_tensor(case["target"][:peaks.shape[0]], device=dev)
        loss = torch.mean((peaks - tgt) ** 2)
        grads = par.psum_grads(torch.autograd.grad(loss, leaves), mesh.group("graph"))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        for t, gr in zip(leaves, grads):
            t.grad = gr
        return {"loss": float(loss.detach()), "grads": _np({k: v for k, v in gnn.tree_map(
            lambda t: t.grad, {k: v for k, v in params.items()
                               if k not in ("peak_std", "peak_avg")}).items()}),
                "counts": {f.__name__: f.launches for f in _cuda.KERNEL_WRAPPERS}}
    if kind == "step":  # one partitioned step, or the data-batched one
        names = task["frames"]
        gs = [Graph(*case["graphs"][n]) for n in names]
        plan = par.make_banded_halo_plan(gs[0].nlist, gs[0].edges, mesh.shape["graph"])
        opt = adam(TrainState(params=params, opt_state={}, lr=task["lr"]))
        if len(gs) == 1:
            step = par.make_partitioned_train_step(cfg, loss_idx, plan, mesh,
                                                   use_kernels=use_kernels)
            loss = step(params, opt, gs[0], case["y"][names[0]], case["w"][names[0]])
        else:
            step = par.make_partitioned_train_step(cfg, loss_idx, plan, mesh, data_axis="data",
                                                   use_kernels=use_kernels)
            graphs = Graph(*[np.stack([getattr(x, f) for x in gs]) for f in Graph._fields])
            loss = step(params, opt, graphs, np.stack([case["y"][n] for n in names]),
                        np.stack([case["w"][n] for n in names]))
        return {"loss": float(loss), "params": _np(params)}
    if kind in ("epoch", "fit"):
        from nmrgnn_tpu_torch.train.partitioned import PartitionedTrainer

        frames = [Sample(Graph(*case["graphs"][n]), case["y"][n], case["w"][n])
                  for n in task["frames"]]
        tr = PartitionedTrainer(cfg, TrainConfig(**task.get("tcfg", {})), mesh=mesh,
                                use_kernels=use_kernels, device=dev)
        if kind == "fit":
            state = tr.init_state()
            state.params = params
            state = tr.fit(frames, frames[:1], state=state, verbose=False)
            return {"history": state.history, "params": _np(state.params),
                    "eval": tr.evaluate(frames, state.params)}
        preps = [tr.prepare(s) for s in frames]
        graphs, ys, ws, arrays, pad_rows = tr._stage_tables(preps)
        order = np.asarray(task["order"])
        out = {"keys": len({p.shape_key for p in preps})}
        for batched in (False, True):
            if batched and mesh.shape["data"] == 1:
                continue
            p_ser = gnn.tree_map(lambda t: t.detach().clone(), params)
            opt_ser = adam(TrainState(params=p_ser, opt_state={}, lr=task["lr"]))
            step = tr._train_step(preps[0], batched=batched)
            serial = []
            groups = [[int(i)] for i in order] if not batched else \
                order.reshape(-1, mesh.shape["data"]).tolist()
            for grp in groups:
                if not batched:
                    p = preps[grp[0]]
                    serial.append(float(step(p_ser, opt_ser, p.graph, p.y, p.w,
                                             arrays=p.arrays)))
                else:
                    serial.append(float(step(
                        p_ser, opt_ser, Graph(*[torch.stack([getattr(preps[i].graph, f)
                                                            for i in grp])
                                                for f in Graph._fields]),
                        torch.stack([preps[i].y for i in grp]),
                        torch.stack([preps[i].w for i in grp]),
                        arrays=[preps[i].arrays for i in grp])))
            p_ep = gnn.tree_map(lambda t: t.detach().clone(), params)
            opt_ep = adam(TrainState(params=p_ep, opt_state={}, lr=task["lr"]))
            ema = gnn.tree_map(lambda t: t.detach().clone(), params)
            losses = tr._epoch_fn(preps[0], batched)(p_ep, opt_ep, ema, graphs, ys, ws, None,
                                                     arrays, order, pad_rows)
            out["batched" if batched else "serial"] = {
                "serial_losses": serial, "serial_params": _np(p_ser),
                "epoch_losses": losses.cpu().numpy(), "epoch_params": _np(p_ep)}
        losses, moments = tr._eval_scan_fn(preps[0])(params, graphs, ys, ws, arrays, pad_rows)
        one = [tr._eval_step(p)(params, p.graph, p.y, p.w, p.arrays, p.pad_rows)
               for p in preps]
        out["eval"] = {"losses": losses.cpu().numpy(), "moments": moments.cpu().numpy(),
                       "one_losses": [float(a) for a, _ in one],
                       "one_moments": np.stack([b.cpu().numpy() for _, b in one])}
        return out
    if kind == "dp_step":  # make_parallel_train_step (DP, DP + TP)
        g = Graph(*[torch.as_tensor(a).to(dev) for a in case["batch"]["graph"]])
        y = torch.as_tensor(case["batch"]["y"]).to(dev)
        w = torch.as_tensor(case["batch"]["w"]).to(dev)
        step, shard_init = par.make_parallel_train_step(cfg, loss_idx, mesh, tp=task["tp"])
        sp, so = shard_init(params, {})
        opt = adam(TrainState(params=sp, opt_state=so, lr=task["lr"]))
        loss = step(sp, opt, g, y, w)
        specs = par.param_specs(params, task["tp"])
        full = par.unshard_params(sp, specs, mesh)
        layout = {"mp_w": tuple(sp["mp"][0]["w"].shape),
                  "fc0": tuple(sp["fc"][0]["kernel"].shape),
                  "out": tuple(sp["out"]["kernel"].shape),
                  "moments": {i: tuple(st["exp_avg"].shape)
                              for i, st in opt.state_dict()["state"].items()}}
        return {"loss": float(loss), "params": _np(full), "layout": layout}
    if kind == "trainer":  # Trainer(mesh=) for an epoch
        samples = [Sample(Graph(*g), y, w)
                   for g, y, w in case[task.get("fragments", "fragments")]]
        tr = Trainer(cfg, TrainConfig(**task["tcfg"]), device=dev, mesh=mesh,
                     tensor_parallel=task.get("tp", False))
        state = tr.init_state()
        state.params = params
        state = tr.fit(samples, [], state=state, verbose=False)
        return {"history": state.history, "params": _np(state.params),
                "banded": tr.use_banded}
    if kind == "noise":  # shard-local draws of the training forward, many keys
        g = Graph(*case["graphs"][task["graph_name"]])
        plan = par.make_banded_halo_plan(g.nlist, g.edges, mesh.shape["graph"])
        with torch.no_grad():
            return {"peaks": np.stack([par.apply_partitioned_banded(
                params, cfg, g, plan, mesh, training=True, rng=1000 + s,
                use_kernels=use_kernels).cpu().numpy() for s in range(task["seeds"])])}
    raise ValueError(kind)


def _task(task, case, mesh, dev):
    import torch

    if task["kind"] in ("grad", "step", "epoch", "fit", "dp_step", "trainer", "noise"):
        return _train_task(task, case, dev)

    from nmrgnn_tpu_torch import parallel as par
    from nmrgnn_tpu_torch.config import ModelConfig
    from nmrgnn_tpu_torch.graph import Graph
    from nmrgnn_tpu_torch.library import params_from_numpy
    from nmrgnn_tpu_torch.models.serving import ServingModel
    from nmrgnn_tpu_torch.ops import _cuda
    from nmrgnn_tpu_torch.ops.edgefn import EdgeCheb

    kind, name = task["kind"], task["model"]
    cfg = ModelConfig(**case["configs"][name])
    params = params_from_numpy(case["params"][name], device=dev)
    g = Graph(*case["graphs"][task["graph"]])
    D = mesh.shape["graph"]
    use_kernels = task.get("use_kernels", True)
    if kind == "serving":
        sm = ServingModel(params, cfg, device=dev, precision=task.get("precision", "exact"),
                          mesh=mesh)
        out = [sm.predict(g) for _ in range(task.get("repeat", 1))]
        return {"peaks": out[-1], "mode": sm._resolve_mode(g),
                "banded": bool(sm._part_plan[1]), "same": all(np.array_equal(o, out[0])
                                                               for o in out)}
    gp = par.pad_to_multiple(g, D * 128)
    if kind == "banded":
        plan = par.make_banded_halo_plan(gp.nlist, gp.edges, D)
        cheb = task.get("cheb")
        if cheb is not None:
            cheb = EdgeCheb(coeffs=torch.as_tensor(cheb[0], device=dev), d_lo=cheb[1],
                            d_hi=cheb[2])
        _cuda.reset_launch_counts()
        peaks = par.apply_partitioned_banded(params, cfg, gp, plan, mesh, cheb=cheb,
                                             use_kernels=use_kernels)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        counts = {f.__name__: f.launches for f in _cuda.KERNEL_WRAPPERS}
        return {"peaks": peaks.cpu().numpy(), "counts": counts}
    if kind == "halo":
        plan = par.make_halo_plan(gp.nlist, D, edges=gp.edges)
        return {"peaks": par.apply_partitioned_halo(params, cfg, gp, plan, mesh).cpu().numpy()}
    if kind == "v1":
        return {"peaks": par.apply_partitioned(params, cfg, gp, mesh).cpu().numpy()}
    raise ValueError(kind)


def run(rank, world, init, case_path, out_dir):
    try:
        import torch

        torch.set_num_threads(1)
        from nmrgnn_tpu_torch import parallel as par

        with open(case_path, "rb") as f:
            case = pickle.load(f)
        par.initialize_distributed(init, rank=rank, world_size=world,
                                   timeout_s=case.get("timeout_s", 120))
        mesh = par.make_mesh(data=1, graph=world)
        dev = torch.device(case.get("device", "cpu"))
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        results = [_task(t, case, mesh, dev) for t in case["tasks"]]
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
        torch.distributed.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)


def spawn(world, case, tmp_path, timeout_s=240):
    """Start ``world`` ranks on ``case`` (written under ``tmp_path``) and
    return (processes, a function that joins them within ``timeout_s`` and
    returns every rank's results, raising with the tracebacks of any rank
    that failed or did not end)."""
    import time
    import multiprocessing as mp

    case_path = os.path.join(str(tmp_path), f"case{world}.pkl")
    out_dir = os.path.join(str(tmp_path), f"out{world}")
    os.makedirs(out_dir, exist_ok=True)
    with open(case_path, "wb") as f:
        pickle.dump(case, f)
    init = "file://" + os.path.join(str(tmp_path), f"init{world}")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=run, args=(r, world, init, case_path, out_dir))
             for r in range(world)]
    for p in procs:
        p.start()

    def join():
        end = time.monotonic() + timeout_s
        for p in procs:
            p.join(max(end - time.monotonic(), 1.0))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        errors = []
        for r, p in enumerate(procs):
            err = os.path.join(out_dir, f"rank{r}.err")
            if p.exitcode != 0:
                text = open(err).read() if os.path.exists(err) else "(no traceback)"
                errors.append(f"rank {r} exited {p.exitcode}:\n{text}")
        if errors:
            raise RuntimeError("\n".join(errors))
        out = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out

    return procs, join
