"""Command-line interface of the port (``nmrgnn_tpu/cli.py``):

    python -m nmrgnn_tpu_torch.cli {train, eval-tfrecords, eval-struct,
        make-fragments, make-struct-records, make-organic, import-reference,
        hyper} ... [--device cuda|cpu]

The same subcommands, arguments, options and output files as the JAX
package's click CLI, on ``argparse``, and one more option, ``--device``
("cuda" by default; "cpu" runs the kernels' plain versions). The files are
written with the standard library: ``eval-tfrecords`` writes its CSV and
its markdown table (merged into an existing one) in the layout pandas'
``DataFrame.to_markdown`` gives (``_markdown_table``). Its "-rmsd" columns
hold the mean squared error, as the reference's published tables do.

``eval-struct --graph-parallel N`` serves each structure split over N
processes, one a card (NCCL) or sharing cards or the CPU (gloo), started
by ``torchrun``::

    torchrun --nproc-per-node W -m nmrgnn_tpu_torch.cli eval-struct \
        STRUCT OUT.csv --graph-parallel N

on a (W // N, N) mesh; rank 0 writes the output. ``train`` takes the JAX
CLI's parallel flags under ``torchrun`` alike::

    torchrun --nproc-per-node W -m nmrgnn_tpu_torch.cli train RECORDS NAME \
        [EPOCHS] --graph-parallel N        # whole structures, split over N
    torchrun ... train FRAGMENTS NAME --data-parallel N [--tensor-parallel]

``--graph-parallel N`` trains on whole structures (``make-struct-records``
output) with ``PartitionedTrainer`` on a (W // N, N) mesh; ``--data-parallel
N`` trains the fragment ``Trainer`` on an (N, W // N with
``--tensor-parallel``, else 1) mesh. Rank 0 writes the model and the
checkpoints; a rank past the mesh ends at once. A usage error exits with
code 2.
"""
from __future__ import annotations

import argparse
import contextlib
import csv
import json
import math
import os
import pickle
import sys
import tempfile
from typing import List, Optional, Sequence

import numpy as np

class UsageError(Exception):
    """A wrong command line: the CLI prints it and exits with code 2."""


def _echo(msg: str = "", err: bool = False, nl: bool = True) -> None:
    stream = sys.stderr if err else sys.stdout
    stream.write(msg + ("\n" if nl else ""))
    stream.flush()


def _existing(paths: Sequence[str]) -> List[str]:
    for p in paths:
        if not os.path.exists(p):
            raise UsageError(f"path {p!r} does not exist")
    return list(paths)


def _device(name: str):
    from ._device import resolve_device

    return resolve_device(name)


def _int_like(s: str) -> bool:
    try:
        int(s)
    except ValueError:
        return False
    return True


# -- train ---------------------------------------------------------------------


def _train(a) -> None:
    from .config import ModelConfig, TrainConfig
    from .data.dataset import split_dataset
    from .data.embeddings import load_embeddings
    from .library import save_model
    from .train.trainer import Trainer

    if a.graph_parallel and (a.data_parallel or a.tensor_parallel):
        raise UsageError("--graph-parallel trains one whole structure per step; combine with "
                         "neither --data-parallel nor --tensor-parallel")
    # TFRECORDS... NAME [EPOCHS], EPOCHS taken from the right as click does
    pos = list(a.args)
    epochs = int(pos.pop()) if len(pos) >= 3 and _int_like(pos[-1]) else 3
    if len(pos) < 2:
        raise UsageError("Must give input TFRecord files")
    name, tfrecords = pos[-1], _existing(pos[:-1])
    dev = _device(a.device)
    emb = load_embeddings(a.embeddings)
    if a.config:
        with open(_existing([a.config])[0]) as f:
            cfg = ModelConfig.from_json(f.read())
    else:
        cfg = ModelConfig()
    checkpoint_path = a.checkpoint_path or os.path.join(tempfile.gettempdir(), "checkpoint")
    tcfg = TrainConfig(
        epochs=epochs, validation=a.validation, loss_balance=a.loss_balance,
        checkpoint_path=checkpoint_path, batch_size=a.batch_size, pad_to=a.pad_to,
        lr_schedule=a.lr_schedule, warmup_epochs=a.warmup_epochs, ema_decay=a.ema_decay,
        restore_best=a.restore_best, seed=a.seed, mp_path=a.mp_path,
        head_decay=a.head_decay, head_decay_elements=a.head_decay_elements,
    )
    with contextlib.ExitStack() as group:
        mesh, lead = None, True
        if a.graph_parallel or a.data_parallel:
            flag, n = (("--graph-parallel", a.graph_parallel) if a.graph_parallel
                       else ("--data-parallel", a.data_parallel))
            world, lead = _start_processes(flag, n, "train", group)
            if a.graph_parallel:
                data, graph = world // n, n
            else:
                data, graph = n, (max(1, world // n) if a.tensor_parallel else 1)
            mesh = _make_mesh(data, graph, world, lead)
            if mesh is None:  # a rank past the mesh: nothing to train
                return
        if lead:
            _echo(f"Loading from {len(tfrecords)} files")
        train_s, val_s = split_dataset(tfrecords, a.validation, cfg.num_elements)
        if lead:
            _echo(f"train={len(train_s)} val={len(val_s)} fragments")
        if a.graph_parallel:
            from .train.partitioned import PartitionedTrainer

            if lead:
                _echo(f"graph-parallel training: mesh {dict(mesh.shape)}")
            trainer = PartitionedTrainer(cfg, tcfg, mesh=mesh, embeddings=emb, device=dev)
        else:
            if mesh is not None and lead:
                _echo(f"mesh: {dict(mesh.shape)}")
            try:
                trainer = Trainer(cfg, tcfg, emb, device=dev, mesh=mesh,
                                  tensor_parallel=a.tensor_parallel)
            except ValueError as e:  # --mp-path banded on an ineligible config
                raise UsageError(str(e)) from e
            if lead:
                _echo(f"training step: {'banded CUDA kernels' if trainer.use_banded else 'gather'}")
        state = trainer.load_checkpoint(checkpoint_path) if a.load else trainer.init_state()
        with _tensorboard(a.tensorboard if lead else None) as callbacks:
            state = trainer.fit(train_s, val_s, epochs=epochs, state=state,
                                checkpoint_path=checkpoint_path, callbacks=callbacks,
                                verbose=lead)
        if lead:
            save_model(name, state.eval_params, cfg)
            _dump_history(name, state.history)
            _echo(f"Saved model to {name}")


@contextlib.contextmanager
def _tensorboard(logdir: Optional[str]):
    """The callbacks of ``train --tensorboard``: each epoch's logs as a
    line of ``scalars.jsonl`` and as scalar events in a tfevents file."""
    if not logdir:
        yield []
        return
    from .utils.tb_events import EventWriter

    os.makedirs(logdir, exist_ok=True)
    events = EventWriter(logdir)
    with open(os.path.join(logdir, "scalars.jsonl"), "a") as logf:
        def log_cb(st, logs):
            logf.write(json.dumps({"epoch": st.epoch, **logs}) + "\n")
            logf.flush()
            events.scalars(logs, st.epoch)
            events.flush()

        try:
            yield [log_cb]
        finally:
            events.close()


def _dump_history(name: str, history: dict) -> None:
    """The history pickle beside the model (reference main.py:84-90)."""
    pfile, i = name + "-history-0.pb", 0
    while os.path.exists(pfile):
        i += 1
        pfile = f"{name}-history-{i}.pb"
    with open(pfile, "wb") as f:
        pickle.dump(history, file=f)


# -- eval-tfrecords ------------------------------------------------------------


def _eval_tfrecords(a) -> None:
    import torch

    from .data.dataset import FragmentLoader, split_dataset
    from .data.embeddings import load_embeddings
    from .graph import Graph
    from .library import load_model
    from .models import gnn
    from .models.infer import apply_banded_fragments, fragment_band_plan
    from .ops.banded import plan_on_device
    from .train.trainer import banded_fragments_eligible

    if not a.tfrecords:
        raise UsageError("Must give input TFRecord files")
    tfrecords = _existing(a.tfrecords)
    dev = _device(a.device)
    params, cfg = load_model(a.model_file and _existing([a.model_file])[0], device=dev)
    model_name = os.path.basename(a.model_file or "baseline")
    train_s, val_s = split_dataset(tfrecords, a.validation, cfg.num_elements)
    data = val_s if a.validation > 0 else train_s
    rev_names = {v: k for k, v in load_embeddings()["name"].items()}

    shape_ok, fits = banded_fragments_eligible(cfg, a.batch_size, a.pad_to)
    if a.mp_path == "banded" and not (shape_ok and fits):
        raise UsageError(
            "--mp-path banded needs the bilinear MP family, 128-aligned pad_to and "
            "atom_feature_size, and a batch working set within the JAX package's budget "
            f"(shape_ok={shape_ok}, vmem_fit={fits})")
    use_banded = a.mp_path == "banded" or (a.mp_path == "auto" and shape_ok and fits
                                           and dev.type == "cuda")
    plans = {}

    def fwd(g: Graph):
        if not use_banded:
            return gnn.apply_batched(params, cfg, g)
        b = g.atoms.shape[0]  # the Trainer's banded eval path, one plan a batch size
        if b not in plans:
            plans[b] = plan_on_device(fragment_band_plan(b, a.pad_to), dev)
        return apply_banded_fragments(params, cfg, g, plan=plans[b])

    loader = FragmentLoader(data, pad_to=a.pad_to, batch_size=a.batch_size, shuffle=False)
    rows = []  # (element, y, yhat, class, name)
    count = 0
    dtypes = (torch.float32, torch.int32, torch.float32, torch.float32)
    with torch.no_grad():
        for g, y, w in loader.batches():
            gt = Graph(*[torch.as_tensor(np.asarray(x)).to(dev, dt) for x, dt in zip(g, dtypes)])
            yhat = fwd(gt).float().cpu().numpy()
            for b in range(y.shape[0]):
                sel = w[b] > 0
                for n_i, yt, yp in zip(y[b][sel, 1], y[b][sel, 0], yhat[b][sel]):
                    cls, atom = rev_names.get(int(n_i), "X-X").split("-", 1)
                    rows.append((atom[0], float(yt), float(yp), cls, atom))
            count += 1
            _echo(f"\rComputing...{count}", nl=False)
    _echo("done")

    with open(f"{model_name}.csv", "w", newline="") as f:
        wr = csv.writer(f, lineterminator="\n")
        wr.writerow(["element", "y", "yhat", "class", "name"])
        wr.writerows(rows)

    results = _shift_table(rows, a.data_name)
    table_rows = [(k, [float(n), float(v)]) for k, (n, v) in results.items()]
    columns = ["N", model_name]
    merge = a.merge
    if merge is None:
        merge = f"{model_name}.md"
    elif os.path.exists(merge):
        columns, table_rows = _concat_tables(columns, table_rows, *_read_markdown(merge))
    with open(merge, "w") as f:
        f.write(_markdown_table(columns, table_rows))
        f.write("\n")
    _echo(f"Wrote {model_name}.csv and {merge}")


def _pearson(x: np.ndarray, y: np.ndarray) -> float:
    """Pearson's r as pandas' ``DataFrame.corr`` gives it (NaN below two
    values or for a constant column)."""
    if len(x) < 2:
        return float("nan")
    dx, dy = x - x.mean(), y - y.mean()
    den = math.sqrt(float((dx * dx).sum()) * float((dy * dy).sum()))
    return float((dx * dy).sum()) / den if den > 0 else float("nan")


def _shift_table(rows, data_name: str) -> dict:
    """{row label: (N, value)}: Pearson's r by element, then by atom name,
    then the mean squared error ("-rmsd") by element and by name, each in
    sorted order (the JAX CLI's table)."""
    elem = np.array([r[0] for r in rows], dtype=object)
    name = np.array([r[4] for r in rows], dtype=object)
    y = np.array([r[1] for r in rows], np.float64)
    yhat = np.array([r[2] for r in rows], np.float64)
    out = {}
    for key, labels in (("r", elem), ("r", name), ("rmsd", elem), ("rmsd", name)):
        for v in sorted(set(labels)):
            m = labels == v
            val = (_pearson(y[m], yhat[m]) if key == "r"
                   else float(np.mean((yhat[m] - y[m]) ** 2)))
            out[f"{data_name}-{v}-{key}"] = (int(m.sum()), val)
    return out


# The markdown table: what pandas' ``DataFrame.to_markdown()`` writes
# (tabulate's "pipe" format with its defaults), and what the JAX CLI reads
# back to merge (``pd.read_table(sep="|", skipinitialspace=True)``, the
# all-empty edge columns and the separator row dropped). Cells are Python
# floats (NaN for a missing one) or, once read back, the strings of the
# file with their leading blanks removed.


def _is_number(v) -> bool:
    if isinstance(v, (int, float)):
        return True
    try:
        f = float(v)
    except (TypeError, ValueError):
        return False
    return not (math.isinf(f) or math.isnan(f)) or v.lower() in ("inf", "-inf", "nan")


def _is_int(v) -> bool:
    if isinstance(v, int):
        return True
    if isinstance(v, str):
        return _int_like(v)
    return False


def _cell_type(v):
    if v is None or v == "":
        return type(None)
    if _is_int(v):
        return int
    if _is_number(v):
        return float
    return str


def _column_type(values):
    rank = {type(None): 0, int: 2, float: 3, str: 5}
    return max((_cell_type(v) for v in values), key=rank.__getitem__, default=type(None))


def _format_cell(v, coltype) -> str:
    if v is None:
        return ""
    if coltype is int:
        return format(v, "")
    if coltype is float:
        return format(float(v), "g")
    return f"{v}"


def _after_point(s: str) -> int:
    if not _is_number(s) or _is_int(s):
        return -1
    pos = s.rfind(".")
    pos = s.lower().rfind("e") if pos < 0 else pos
    return len(s) - pos - 1 if pos >= 0 else -1


def _align(cells: List[str], numeric: bool, minwidth: int) -> List[str]:
    if numeric:  # decimal points lined up, then flushed right
        dec = [_after_point(s) for s in cells]
        cells = [s + (max(dec) - d) * " " for s, d in zip(cells, dec)]
        width = max([minwidth] + [len(s) for s in cells])
        return [s.rjust(width) for s in cells]
    cells = [s.strip() for s in cells]
    width = max([minwidth] + [len(s) for s in cells])
    return [s.ljust(width) for s in cells]


def _markdown_table(columns: Sequence[str], rows) -> str:
    """The pipe table of ``rows`` [(label, [cell per column])] under the
    headers ``columns``, with an unnamed label column."""
    headers = [""] + list(columns)
    cols = [[r[0] for r in rows]] + [[r[1][j] for r in rows] for j in range(len(columns))]
    out_cols, numeric = [], []
    for h, c in zip(headers, cols):
        ct = _column_type(c)
        num = ct in (int, float)
        numeric.append(num)
        out_cols.append(_align([_format_cell(v, ct) for v in c], num, len(h) + 2))
    widths = [max([len(h) + 2] + [len(s) for s in c]) for h, c in zip(headers, out_cols)]
    head = [h.rjust(w) if num else h.ljust(w) for h, w, num in zip(headers, widths, numeric)]
    lines = ["|" + "|".join(f" {h} " for h in head) + "|",
             "|" + "|".join(("-" * (w + 1) + ":") if num else (":" + "-" * (w + 1))
                            for w, num in zip(widths, numeric)) + "|"]
    for i in range(len(rows)):
        lines.append("|" + "|".join(f" {c[i]} " for c in out_cols) + "|")
    return "\n".join(lines)


def _read_markdown(path: str):
    """(columns, rows) of a markdown table as the JAX CLI reads one back to
    merge: every field with its leading blanks removed, the headers with
    every blank removed."""
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    split = [ln.split("|")[1:-1] for ln in lines]
    columns = [h.replace(" ", "") for h in split[0][1:]]
    rows = [(fields[0].lstrip(), [v.lstrip() for v in fields[1:]]) for fields in split[2:]]
    return columns, rows


def _concat_tables(columns, rows, other_columns, other_rows):
    """``pd.concat([results, other])``: the rows of both, the columns of
    the first then the other's new ones, NaN where a table lacks one."""
    merged = list(columns) + [c for c in other_columns if c not in columns]

    def widen(cols, rs):
        at = {c: j for j, c in enumerate(cols)}
        return [(lab, [vals[at[c]] if c in at else float("nan") for c in merged])
                for lab, vals in rs]

    return merged, widen(columns, rows) + widen(other_columns, other_rows)


# -- eval-struct ---------------------------------------------------------------


def _eval_struct(a) -> None:
    if len(a.args) < 2:
        raise UsageError("Must pass at least one structure file")
    struct_files, output_csv = _existing(a.args[:-1]), a.args[-1]
    with contextlib.ExitStack() as group:
        mesh = None
        if a.graph_parallel:
            mesh = _graph_parallel_mesh(a, group)
            if mesh is None:  # a rank past the mesh: nothing to serve
                return
        _serve_structs(a, struct_files, output_csv, mesh)


def _start_processes(flag: str, n: int, command: str, group: contextlib.ExitStack):
    """(world, lead) of the W processes ``torchrun`` started for ``flag N``
    (the process group is started here and ended when ``group`` closes):
    N past W is a usage error; ``lead`` is rank 0."""
    import torch.distributed as dist

    from .parallel import initialize_distributed

    if initialize_distributed() is not None:
        group.callback(dist.destroy_process_group)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n > world:
        hint = "" if dist.is_initialized() else (
            "; start one process a shard with torchrun --nproc-per-node N -m "
            f"nmrgnn_tpu_torch.cli {command} ...")
        raise UsageError(f"{flag} {n} exceeds the {world} process(es){hint}")
    lead = not dist.is_initialized() or dist.get_rank() == 0
    return world, lead


def _make_mesh(data: int, graph: int, world: int, lead: bool):
    """The (data, graph) mesh over the ``world`` processes; None on a rank
    past it (every rank makes the mesh's groups first)."""
    from .parallel import make_mesh

    if data * graph < world and lead:
        _echo(f"note: a {data} x {graph} mesh uses {data * graph} of the {world} processes",
              err=True)
    mesh = make_mesh(data=data, graph=graph)
    return None if mesh.rank >= data * graph else mesh


def _graph_parallel_mesh(a, group: contextlib.ExitStack):
    """The (W // N, N) mesh of ``eval-struct --graph-parallel N`` over the
    W processes ``torchrun`` started (the process group is started here
    and ended when ``group`` closes); None on a rank past W // N * N."""
    n = a.graph_parallel
    world, lead = _start_processes("--graph-parallel", n, "eval-struct", group)
    if a.fast and lead:
        _echo("note: --fast is ignored with --graph-parallel (the partitioned banded "
              "forward is its own path); --precision fast applies bf16 arithmetic AND the "
              "Chebyshev edge stage inside the per-shard band builds", err=True)
    mesh = _make_mesh(world // n, n, world, lead)
    if mesh is not None and lead:
        _echo(f"graph-parallel serving: mesh {dict(mesh.shape)}")
    return mesh


def _serve_structs(a, struct_files, output_csv, mesh) -> None:
    import torch

    from .data.neighbors import neighbors_device, neighbors_host
    from .data.parse import ANGSTROM_TO_NM, atoms_one_hot, inv_degree_np
    from .data.pdb import read_structure
    from .graph import Graph, bucket_size
    from .library import check_peaks, load_model
    from .models import gnn
    from .utils.profiling import TimingBuckets

    lead = mesh is None or mesh.rank == 0
    echo = _echo if lead else (lambda *args, **kw: None)
    dev = _device(a.device)
    params, cfg = load_model(a.model_file and _existing([a.model_file])[0], device=dev)

    timing = TimingBuckets("graph", "inference", "output", "read")
    with timing("read"):
        struct = read_structure(*struct_files)
    n = struct.n_atoms
    pad_n = bucket_size(n)
    atoms_np = atoms_one_hot(struct.elements, cfg.num_elements)
    atoms_pad = torch.as_tensor(np.pad(atoms_np, ((0, pad_n - n), (0, 0)))).to(dev)

    serving = None
    if a.fast and a.device_graph and mesh is None:
        _echo("note: --device-graph is ignored with --fast (the serving path builds graphs "
              "host-side, pipelined with inference)", err=True)
    if mesh is not None or a.fast:
        from .models.serving import ServingModel

        serving = ServingModel(params, cfg, device=dev, precision=a.precision, mesh=mesh)

    frames = range(0, struct.n_frames, a.stride)
    rows: List[list] = []
    echo(f"Running on {dev.type} ({len(frames)} frame(s), {n} atoms)")

    def emit_frame(i, peaks):
        with timing("output"):
            try:
                confident = check_peaks(atoms_np, peaks)
            except Warning as wrn:
                echo(f"warning: {wrn}", err=True)
                confident = np.zeros(n, bool)
            peaks = np.round(np.asarray(peaks, np.float32), 2)
            for j in range(n):
                rows.append([j, struct.resnames[j], struct.resids[j], struct.names[j],
                             str(peaks[j]), bool(confident[j]), float(i), i])
        echo(timing.summary())

    with contextlib.ExitStack() as stack, torch.no_grad():
        if a.profile:
            from .utils.profiling import trace

            stack.enter_context(trace(a.profile))
            echo(f"profiling to {a.profile}")
        if serving is not None:
            # the host's graph builds overlap the card's forwards
            # (ServingModel.predict_trajectory); the graph time is inside
            # the inference bucket
            served = serving.predict_trajectory(struct, stride=a.stride,
                                                neighbor_number=a.neighbor_number)
            while True:
                with timing("inference"):
                    item = next(served, None)
                if item is None:
                    break
                emit_frame(*item)
        else:
            for i in frames:
                with timing("graph"):
                    if a.device_graph:
                        coords = torch.as_tensor(
                            np.pad(struct.coords[i], ((0, pad_n - n), (0, 0)))).to(dev)
                        nlist, dists = neighbors_device(coords, a.neighbor_number, n_real=n)
                        deg = (nlist > 0).sum(-1).to(torch.float32)
                        inv = torch.where(deg > 0, 1.0 / deg.clamp(min=1.0),
                                          torch.zeros_like(deg))
                        g = Graph(atoms_pad, nlist.to(torch.int32), dists * ANGSTROM_TO_NM, inv)
                    else:
                        nlist_np, dists_np = neighbors_host(struct.coords[i], a.neighbor_number)
                        edges_np = (dists_np * ANGSTROM_TO_NM).astype(np.float32)
                        pad = ((0, pad_n - n), (0, 0))
                        g = Graph(atoms_pad,
                                  torch.as_tensor(np.pad(nlist_np, pad).astype(np.int32)).to(dev),
                                  torch.as_tensor(np.pad(edges_np, pad)).to(dev),
                                  torch.as_tensor(np.pad(inv_degree_np(nlist_np),
                                                         ((0, pad_n - n),))).to(dev))
                with timing("inference"):
                    peaks = gnn.apply(params, cfg, g).float().cpu().numpy()[:n]
                emit_frame(i, peaks)
    if not lead:
        return
    with open(output_csv, "w", newline="") as f:
        wr = csv.writer(f, lineterminator="\n")
        wr.writerow(["index", "residues", "resids", "names", "peaks", "confident", "time",
                     "frame"])
        wr.writerows(rows)
    _echo(f"Done. Results in {output_csv}")


# -- data and model files --------------------------------------------------------


def _make_fragments(a) -> None:
    from .data.fragment import write_structure_fragments
    from .data.pdb import read_structure

    if len(a.args) < 2:
        raise UsageError("Must pass structure files and an output TFRecord")
    total = 0
    for sf in _existing(a.args[:-1]):
        struct = read_structure(sf)
        r = range(min(a.frames, struct.n_frames)) if a.frames else None
        total += write_structure_fragments(a.args[-1], struct, frames=r,
                                           fragment_size=a.fragment_size,
                                           neighbor_number=a.neighbor_number)
    _echo(f"Wrote {total} fragments to {a.args[-1]}")


def _read_shifts(path: str, n_frames: int, n_atoms: int) -> np.ndarray:
    """f32[frames, atoms] labels from a CSV with columns index, shift and
    optionally frame (frame 0 without it); NaN where none is given."""
    shifts = np.full((n_frames, n_atoms), np.nan, np.float32)
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            fr = int(row.get("frame") or 0)
            if fr < n_frames:
                shifts[fr, int(row["index"])] = float(row["shift"])
    return shifts


def _make_struct_records(a) -> None:
    from .data.fragment import write_structure_records
    from .data.pdb import read_structure

    if len(a.args) < 2:
        raise UsageError("Must pass structure files and an output TFRecord")
    struct_files = _existing(a.args[:-1])
    if a.shifts and len(struct_files) > 1:
        raise UsageError("--shifts labels a single structure; run make-struct-records once "
                         "per structure (append by reusing the output path is not supported "
                         "with --shifts)")
    total, append = 0, False
    for sf in struct_files:
        struct = read_structure(sf)
        r = range(min(a.frames, struct.n_frames)) if a.frames else None
        shifts = None
        if a.shifts:
            nf = struct.n_frames if r is None else len(r)
            shifts = _read_shifts(_existing([a.shifts])[0], nf, struct.n_atoms)
        total += write_structure_records(a.args[-1], struct, frames=r, shifts=shifts,
                                         neighbor_number=a.neighbor_number, append=append)
        append = True
    _echo(f"Wrote {total} whole-structure records to {a.args[-1]}")


def _make_organic(a) -> None:
    from .data.organic import write_organic_fragments

    n = write_organic_fragments(a.output_tfrecord, n_molecules=a.molecules, seed=a.seed,
                                append=a.append)
    _echo(f"Wrote {n} molecules to {a.output_tfrecord}")


def _import_reference(a) -> None:
    from .compat import import_reference_checkpoint
    from .config import ModelConfig
    from .library import save_model
    from .models.gnn import count_params

    cfg = None
    if a.config:
        with open(_existing([a.config])[0]) as f:
            cfg = ModelConfig.from_json(f.read())
    params, cfg = import_reference_checkpoint(a.checkpoint, config=cfg, device=_device(a.device))
    save_model(a.out_dir, params, cfg)
    _echo(f"Imported {count_params(params)} params from {a.checkpoint} -> {a.out_dir}")


def _hyper(a) -> None:
    from .train.hyper import run_hyper

    pos = list(a.args)  # TFRECORDS... [EPOCHS], EPOCHS from the right
    epochs = int(pos.pop()) if len(pos) >= 2 and _int_like(pos[-1]) else 3
    if not pos:
        raise UsageError("Must give input TFRecord files")
    best = run_hyper(_existing(pos), epochs=epochs, validation=a.validation, trials=a.trials,
                     tuning_path=a.tuning_path, seed=a.seed, embeddings_path=a.embeddings,
                     batch_size=a.batch_size, pad_to=a.pad_to, device=_device(a.device))
    _echo(f"Best config written to {a.tuning_path}/best_config.json")
    _echo(best.to_json())


# -- the parser ----------------------------------------------------------------


def _switch(p, on: str, off: str, dest: str, default: bool, help: str) -> None:
    p.add_argument(on, dest=dest, action="store_true", default=default, help=help)
    p.add_argument(off, dest=dest, action="store_false")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m nmrgnn_tpu_torch.cli",
        description="nmrgnn on PyTorch and CUDA: NMR chemical shift prediction.")
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    sub = parser.add_subparsers(dest="command", required=True, metavar="COMMAND")

    p = sub.add_parser("train", parents=[common],
                       help="Train the model on fragment TFRecords.")
    p.add_argument("args", nargs="+", metavar="TFRECORDS... NAME [EPOCHS]")
    p.add_argument("--checkpoint-path", default=None,
                   help="checkpoint directory (default: checkpoint in the temporary directory)")
    p.add_argument("--embeddings", default=None, help="path to embeddings JSON")
    p.add_argument("--validation", type=float, default=0.1, help="relative size of validation")
    p.add_argument("--tensorboard", default=None,
                   help="log dir for TensorBoard event files (+ scalars.jsonl)")
    _switch(p, "--load", "--noload", "load", False, "resume from checkpoint path")
    p.add_argument("--loss-balance", type=float, default=1.0,
                   help="L2 (1.0) vs corr (0.0) balance")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--pad-to", type=int, default=256)
    p.add_argument("--config", default=None, help="ModelConfig JSON (default: the baseline)")
    p.add_argument("--data-parallel", type=int, default=0,
                   help="split batches over N processes started by torchrun (0 = one process)")
    p.add_argument("--tensor-parallel", action=argparse.BooleanOptionalAction, default=False,
                   help="also split the MP / FC kernels over the remaining processes")
    p.add_argument("--graph-parallel", type=int, default=0,
                   help="train on WHOLE structures (make-struct-records input), atoms split "
                        "over N processes started by torchrun (0 = off)")
    p.add_argument("--lr-schedule", default="plateau", choices=["plateau", "cosine"])
    p.add_argument("--warmup-epochs", type=int, default=0)
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="params EMA for eval/export (0 = off)")
    p.add_argument("--restore-best", action=argparse.BooleanOptionalAction, default=False,
                   help="export the best-validation weights instead of the last")
    p.add_argument("--seed", type=int, default=0, help="init/shuffle RNG seed")
    p.add_argument("--mp-path", default="auto", choices=["auto", "banded", "gather"],
                   help="training-step message passing: banded = the CUDA kernels (auto on "
                        "the card when eligible), gather = plain PyTorch")
    p.add_argument("--head-decay", type=float, default=0.0)
    p.add_argument("--head-decay-elements", default="N")
    p.set_defaults(run=_train)

    p = sub.add_parser("eval-tfrecords", parents=[common],
                       help="Evaluate on fragment TFRecords ({model}.csv and a markdown table).")
    p.add_argument("tfrecords", nargs="*")
    p.add_argument("--model-file", default=None)
    p.add_argument("--validation", type=float, default=0.0)
    p.add_argument("--data-name", default="")
    p.add_argument("--merge", default=None, help="merge results into a markdown table")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--pad-to", type=int, default=256)
    p.add_argument("--mp-path", default="auto", choices=["auto", "gather", "banded"])
    p.set_defaults(run=_eval_tfrecords)

    p = sub.add_parser("eval-struct", parents=[common],
                       help="Predict chemical shifts for structure file(s).")
    p.add_argument("args", nargs="*", metavar="STRUCT_FILES... OUTPUT_CSV")
    p.add_argument("--model-file", default=None)
    p.add_argument("--neighbor-number", type=int, default=16)
    p.add_argument("--stride", type=int, default=1, help="trajectory frame stride")
    _switch(p, "--device-graph", "--host-graph", "device_graph", False,
            "build neighbor lists on the device instead of the host")
    p.add_argument("--fast", action=argparse.BooleanOptionalAction, default=False,
                   help="serve through ServingModel (the banded CUDA kernels)")
    p.add_argument("--precision", default="exact", choices=["exact", "fast"])
    p.add_argument("--profile", default=None, help="write a torch.profiler trace here")
    p.add_argument("--graph-parallel", type=int, default=0,
                   help="split each structure's atoms over N processes started by torchrun "
                        "(the partitioned banded forward; 0 = one process)")
    p.set_defaults(run=_eval_struct)

    p = sub.add_parser("make-fragments", parents=[common],
                       help="Fragment structures into a training TFRecord.")
    p.add_argument("args", nargs="*", metavar="STRUCT_FILES... OUTPUT_TFRECORD")
    p.add_argument("--fragment-size", type=int, default=256)
    p.add_argument("--neighbor-number", type=int, default=16)
    p.add_argument("--frames", type=int, default=None, help="limit trajectory frames")
    p.set_defaults(run=_make_fragments)

    p = sub.add_parser("make-struct-records", parents=[common],
                       help="Write whole-structure labeled records (one per frame).")
    p.add_argument("args", nargs="*", metavar="STRUCT_FILES... OUTPUT_TFRECORD")
    p.add_argument("--neighbor-number", type=int, default=16)
    p.add_argument("--frames", type=int, default=None, help="limit trajectory frames")
    p.add_argument("--shifts", default=None,
                   help="CSV of labels with columns index,shift[,frame]")
    p.set_defaults(run=_make_struct_records)

    p = sub.add_parser("make-organic", parents=[common],
                       help="Generate a synthetic organic small-molecule TFRecord.")
    p.add_argument("output_tfrecord")
    p.add_argument("--molecules", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--append", action=argparse.BooleanOptionalAction, default=False)
    p.set_defaults(run=_make_organic)

    p = sub.add_parser("import-reference", parents=[common],
                       help="Convert a reference TF checkpoint into a model directory.")
    p.add_argument("checkpoint")
    p.add_argument("out_dir")
    p.add_argument("--config", default=None)
    p.set_defaults(run=_import_reference)

    p = sub.add_parser("hyper", parents=[common],
                       help="Tune hyperparameters (successive-halving random search).")
    p.add_argument("args", nargs="*", metavar="TFRECORDS... [EPOCHS]")
    p.add_argument("--tuning_path", default="tuning")
    p.add_argument("--embeddings", default=None)
    p.add_argument("--validation", type=float, default=0.1)
    p.add_argument("--trials", type=int, default=8, help="number of sampled configurations")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--pad-to", type=int, default=256)
    p.set_defaults(run=_hyper)
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    try:
        args.run(args)
    except UsageError as e:
        parser.exit(2, f"{parser.prog} {args.command}: error: {e}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
