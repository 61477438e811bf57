"""One rank of the port's partitioned forwards, spawned by
``tests/test_torch_parallel.py`` (gloo on the CPU) and
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


def _task(task, case, mesh, dev):
    import torch

    from nmrgnn_tpu_torch import parallel as par
    from nmrgnn_tpu_torch.config import ModelConfig
    from nmrgnn_tpu_torch.graph import Graph
    from nmrgnn_tpu_torch.library import params_from_numpy
    from nmrgnn_tpu_torch.models.serving import ServingModel
    from nmrgnn_tpu_torch.ops import banded
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
        banded.reset_launch_counts()
        peaks = par.apply_partitioned_banded(params, cfg, gp, plan, mesh, cheb=cheb,
                                             use_kernels=use_kernels)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        counts = {f.__name__: f.launches for f in banded.KERNEL_WRAPPERS}
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
