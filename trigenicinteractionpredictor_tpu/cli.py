"""Command-line entry points (reference layer L6).

The reference is driven as ``python src/TrigenicInteractionPredictor.py
-f data.tsv -k 10 -i 400 -s 10`` (SURVEY.md §2 L6).  The equivalents here:

    python -m trigenicinteractionpredictor_tpu fit   -f data.tsv -k 10 -i 400 -s 10 -o runs/fit
    python -m trigenicinteractionpredictor_tpu cv    -f data.tsv -k 10 --folds 5
    python -m trigenicinteractionpredictor_tpu sweep -f data.tsv --k-grid 5,10,25,50
    python -m trigenicinteractionpredictor_tpu predict -f data.tsv --checkpoint runs/fit/model.ckpt.npz
    python -m trigenicinteractionpredictor_tpu synth -o synth.npz -n 100000 -g 1000
    python -m trigenicinteractionpredictor_tpu bench

``-f`` accepts either a Kuzmin-style TSV or a packed ``.npz``
(data/packing.py).  Every run writes its Config, JSONL events, a resumable
checkpoint, reference-style text dumps, and a JSON report into ``-o``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np


def _load_dataset(path: str, cfg):
    from trigenicinteractionpredictor_tpu.data.kuzmin import load_kuzmin_tsv
    from trigenicinteractionpredictor_tpu.data.packing import TripletDataset

    if os.path.isdir(path):
        # save_dir() layout: memory-mapped for beyond-HBM streaming.
        return TripletDataset.load_dir(path, mmap=True)
    if path.endswith(".npz"):
        return TripletDataset.load_npz(path)
    return load_kuzmin_tsv(path, cfg.data)


def _base_parser(sub: argparse.ArgumentParser) -> None:
    sub.add_argument("-f", "--file", required=True, help="TSV or packed .npz dataset")
    sub.add_argument("-k", type=int, default=10, help="latent groups K")
    sub.add_argument("-i", "--iterations", type=int, default=400, help="EM sweeps")
    sub.add_argument("-s", "--samples", type=int, default=1, help="random restarts")
    sub.add_argument("-n", "--freq", type=int, default=10, help="likelihood check frequency")
    sub.add_argument("--tol", type=float, default=0.0, help="early-stop |dL| tolerance")
    sub.add_argument("--seed", type=int, default=0)
    sub.add_argument("-o", "--out", default=None, help="output directory")
    sub.add_argument("--mesh-data", type=int, default=None, help="data-axis size (default: all devices)")
    sub.add_argument("--mesh-ensemble", type=int, default=1)
    sub.add_argument(
        "--mesh-model", type=int, default=1,
        help="tensor-parallel shards of the K^3 group tensor p (large-K "
        "regime; K must divide by this)",
    )
    sub.add_argument("--checkpoint-every", type=int, default=0)
    sub.add_argument("--test-fraction", type=float, default=0.2)
    sub.add_argument("--tau-mode", choices=["abs", "negative"], default="abs")
    sub.add_argument(
        "--mutant-type", choices=["trigenic", "digenic"], default="trigenic",
        help="TSV row filter: trigenic triplets (3-way model family) or "
        "digenic pairs (2-way family)",
    )
    sub.add_argument("--p-cutoff", type=float, default=0.05)
    sub.add_argument("--tau-cutoff", type=float, default=0.08)
    sub.add_argument(
        "--profile", default=None, metavar="DIR",
        help="write a jax.profiler (perfetto) trace of the run to DIR",
    )
    sub.add_argument(
        "--debug-nans", action="store_true",
        help="raise on the first NaN produced on device (jax_debug_nans)",
    )
    sub.add_argument(
        "--minibatch", type=int, default=0,
        help="stepwise EM: update params every this many rows (0 = classic "
        "full-sweep EM; -i counts epochs in this mode)",
    )
    sub.add_argument(
        "--kappa", type=float, default=0.6,
        help="stepwise EM statistics decay exponent, in (0.5, 1]",
    )
    sub.add_argument(
        "--stream-groups", type=int, default=0,
        help="stepwise streaming: minibatches per device dispatch (0 = "
        "whole epoch at once); keeps only one group in HBM for datasets "
        "bigger than device memory (two with --stream-prefetch, the "
        "default)",
    )
    sub.add_argument(
        "--no-stream-prefetch", action="store_true",
        help="disable the one-group-lookahead prefetch (strict one-group "
        "HBM residency; host prep serializes with device compute)",
    )
    sub.add_argument(
        "--stream-prep-workers", type=int, default=0,
        help="streaming host-prep process pool: 0 = auto (pool only with "
        "spare cores), 1 = in-thread, N >= 2 = pool of N spawn workers",
    )
    sub.add_argument(
        "--anneal-beta0", type=float, default=1.0,
        help="deterministic-annealing start temperature (beta0 < 1 smooths "
        "early responsibilities; ramps to 1; 1.0 = off)",
    )
    sub.add_argument(
        "--anneal-sweeps", type=int, default=0,
        help="sweeps over which beta ramps to 1 (0 = half of -i)",
    )
    sub.add_argument(
        "--refine-rounds", type=int, default=0,
        help="perturb-and-resweep rounds from the best restart after the "
        "main fit (0 = off)",
    )
    sub.add_argument(
        "--refine-sweeps", type=int, default=0,
        help="extra sweeps per refinement round (0 = i/4)",
    )
    sub.add_argument(
        "--refine-eps", type=float, default=0.25,
        help="refinement perturbation strength toward Dirichlet noise",
    )
    sub.add_argument(
        "--smem-rounds", type=int, default=0,
        help="split-merge EM rounds after the main fit: merge+split "
        "topology jumps from the best restart, accepted only on "
        "likelihood improvement (0 = off)",
    )
    sub.add_argument(
        "--smem-sweeps", type=int, default=0,
        help="extra sweeps per split-merge round (0 = i/4)",
    )
    sub.add_argument(
        "--init", choices=["random", "spectral"], default="random",
        help="restart initialization: reference-style random simplexes or "
        "informed spectral init from pairwise co-interaction marginals",
    )


def _make_config(args, n_folds: int = 1):
    import jax

    from trigenicinteractionpredictor_tpu.config import (
        Config,
        DataConfig,
        EngineConfig,
        MeshConfig,
        SplitConfig,
        TrainConfig,
    )

    n_dev = len(jax.devices())
    ens = args.mesh_ensemble
    model = getattr(args, "mesh_model", 1)
    data = (
        args.mesh_data
        if args.mesh_data is not None
        else max(n_dev // (ens * model), 1)
    )
    return Config(
        data=DataConfig(
            path=args.file,
            p_cutoff=args.p_cutoff,
            tau_cutoff=args.tau_cutoff,
            tau_mode=args.tau_mode,
            mutant_type=getattr(args, "mutant_type", "trigenic"),
        ),
        train=TrainConfig(
            k=args.k,
            sweeps=args.iterations,
            samples=args.samples,
            likelihood_freq=args.freq,
            tol=args.tol,
            seed=args.seed,
            checkpoint_every=args.checkpoint_every,
            debug_nans=getattr(args, "debug_nans", False),
            minibatch=getattr(args, "minibatch", 0),
            stepwise_kappa=getattr(args, "kappa", 0.6),
            stream_groups=getattr(args, "stream_groups", 0),
            stream_prefetch=not getattr(args, "no_stream_prefetch", False),
            stream_prep_workers=getattr(args, "stream_prep_workers", 0),
            anneal_beta0=getattr(args, "anneal_beta0", 1.0),
            anneal_sweeps=getattr(args, "anneal_sweeps", 0),
            refine_rounds=getattr(args, "refine_rounds", 0),
            refine_sweeps=getattr(args, "refine_sweeps", 0),
            refine_eps=getattr(args, "refine_eps", 0.25),
            smem_rounds=getattr(args, "smem_rounds", 0),
            smem_sweeps=getattr(args, "smem_sweeps", 0),
            init_method=getattr(args, "init", "random"),
        ),
        split=SplitConfig(
            test_fraction=args.test_fraction, n_folds=n_folds, seed=args.seed
        ),
        mesh=MeshConfig(data=data, ensemble=ens, model=model),
        engine=EngineConfig(),
        out_dir=args.out or "runs/run",
    )


def cmd_fit(args) -> int:
    import contextlib

    from trigenicinteractionpredictor_tpu.data.splits import train_test_split
    from trigenicinteractionpredictor_tpu.eval import evaluate
    from trigenicinteractionpredictor_tpu.parallel.distributed import maybe_initialize
    from trigenicinteractionpredictor_tpu.train.checkpoint import write_text_dump
    from trigenicinteractionpredictor_tpu.train.trainer import fit
    from trigenicinteractionpredictor_tpu.utils.logging import JsonlLogger
    from trigenicinteractionpredictor_tpu.utils.profiling import trace

    maybe_initialize()
    cfg = _make_config(args)
    os.makedirs(cfg.out_dir, exist_ok=True)
    with open(os.path.join(cfg.out_dir, "config.json"), "w") as fh:
        fh.write(cfg.to_json())
    ds = _load_dataset(args.file, cfg)
    train, test = train_test_split(ds, cfg.split.test_fraction, cfg.split.seed)
    logger = JsonlLogger(os.path.join(cfg.out_dir, "events.jsonl"))
    prof = trace(args.profile) if args.profile else contextlib.nullcontext()
    with prof:
        result = fit(
            cfg,
            train,
            logger=logger,
            checkpoint_path=os.path.join(cfg.out_dir, "model.ckpt.npz"),
            resume=args.resume,
        )
    report = evaluate(result.states, test, result.final_loglik)
    write_text_dump(
        os.path.join(cfg.out_dir, "params"),
        result.states,
        result.ll_trace,
        gene_names=ds.gene_names,
    )
    out = {
        **report.to_dict(),
        "ll_best": float(result.final_loglik.max()),
        "sweeps": result.sweeps_run,
        "triplets_per_sec": result.triplets_per_sec,
    }
    with open(os.path.join(cfg.out_dir, "report.json"), "w") as fh:
        json.dump(out, fh, indent=2)
    print(json.dumps(out))
    return 0


def _run_grid(args, k_grid: List[int], n_folds: int) -> int:
    import jax

    from trigenicinteractionpredictor_tpu.parallel.distributed import maybe_initialize
    from trigenicinteractionpredictor_tpu.train.driver import merge_report, run_units

    maybe_initialize()
    cfg = _make_config(args, n_folds=n_folds)
    os.makedirs(cfg.out_dir, exist_ok=True)
    with open(os.path.join(cfg.out_dir, "config.json"), "w") as fh:
        fh.write(cfg.to_json())
    ds = _load_dataset(args.file, cfg)
    run_units(cfg, ds, k_grid=k_grid)
    if jax.process_count() > 1:
        # The merge below reads every process's DONE markers — barrier so
        # host 0 does not merge a partial grid (units finish at different
        # times across hosts).
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("units_done")
    if jax.process_index() == 0:
        report = merge_report(cfg.out_dir)
        print(json.dumps(report["summary"]))
    return 0


def cmd_cv(args) -> int:
    return _run_grid(args, k_grid=[args.k], n_folds=args.folds)


def cmd_sweep(args) -> int:
    k_grid = [int(x) for x in args.k_grid.split(",")]
    return _run_grid(args, k_grid=k_grid, n_folds=args.folds)


def cmd_predict(args) -> int:
    import time

    from trigenicinteractionpredictor_tpu.models.mmsbm import ModelState
    from trigenicinteractionpredictor_tpu.ops.scoring import (
        serve_predict_interaction,
    )
    from trigenicinteractionpredictor_tpu.train.checkpoint import load_checkpoint

    cfg = _make_config(args)
    ds = _load_dataset(args.file, cfg)
    ck = load_checkpoint(args.checkpoint)
    states = ModelState(theta=ck["states"].theta, p=ck["states"].p)
    t0 = time.perf_counter()
    # Chained-dispatch serving path: one compiled block shape, one sync
    # for the whole input.
    scores = serve_predict_interaction(states, ds.triplets)
    score_wall = time.perf_counter() - t0
    out = args.out or "predictions.tsv"
    names = ds.gene_names or [str(i) for i in range(ds.n_genes)]
    cols = ["gene_a", "gene_b", "gene_c"][: ds.arity]
    name_arr = np.asarray(names, dtype=object)
    gene_cols = name_arr[ds.triplets]
    with open(out, "w") as fh:
        fh.write("\t".join(cols) + "\tp_interaction\n")
        fh.write(
            "\n".join(
                "\t".join(row) + f"\t{s:.6f}"
                for row, s in zip(gene_cols, scores)
            )
        )
        fh.write("\n")
    print(
        json.dumps(
            {
                "n": len(scores),
                "out": out,
                "rows_per_sec": round(len(scores) / max(score_wall, 1e-9), 1),
            }
        )
    )
    return 0


def cmd_analyze(args) -> int:
    from trigenicinteractionpredictor_tpu.analysis import (
        analyze_checkpoint,
        write_analysis,
    )

    from trigenicinteractionpredictor_tpu.config import DataConfig

    tuples = labels = None
    if args.file:
        dcfg = DataConfig(
            path=args.file,
            p_cutoff=args.p_cutoff,
            tau_cutoff=args.tau_cutoff,
            tau_mode=args.tau_mode,
            mutant_type=args.mutant_type,
        )

        class _Shim:
            data = dcfg

        ds = _load_dataset(args.file, _Shim)
        tuples, labels = ds.triplets, ds.ratings
    report = analyze_checkpoint(args.checkpoint, tuples=tuples, labels=labels)
    out = args.out or "analysis.json"
    write_analysis(report, out)
    print(
        json.dumps(
            {
                k: report[k]
                for k in (
                    "n_samples",
                    "best_sample",
                    "loglik_spread",
                    "group_stability",
                )
                if k in report
            }
        )
    )
    return 0


def cmd_synth(args) -> int:
    from trigenicinteractionpredictor_tpu.data.synthetic import (
        sample_synthetic_dataset,
    )

    ds, theta, p = sample_synthetic_dataset(
        args.n,
        args.genes,
        args.k,
        n_ratings=args.ratings,
        seed=args.seed,
        arity=args.arity,
    )
    written = ds.save_npz(args.out)
    if args.ground_truth:
        np.savez(args.ground_truth, theta=theta, p=p)
    print(
        json.dumps(
            {"out": written, "n": ds.n_rows, "genes": ds.n_genes, "k": args.k}
        )
    )
    return 0


def cmd_verify_parity(args) -> int:
    from trigenicinteractionpredictor_tpu.parity import run_verify_parity

    cfg = _make_config(args)
    report = run_verify_parity(
        args.file, cfg, cfg.out_dir, do_fit=not args.no_fit
    )
    summary = {
        "reference_files": report["reference_mount"]["n_files"],
        "out": os.path.join(cfg.out_dir, "verify_parity.json"),
        **{
            k: v["rows"]
            for k, v in report["loader_fingerprint"]["modes"].items()
        },
    }
    if "artifact" in report:
        summary["heldout_auc"] = report["artifact"]["converged"]["auc"]
        summary["train_ll_best"] = report["artifact"]["converged"][
            "train_loglik_best"
        ]
    print(json.dumps(summary))
    return 0


def cmd_bench(args) -> int:
    # bench.py runs in a child process that needs the whole device: this
    # process must not have opened a backend (nothing on this path calls
    # jax.devices()), or the child would find the card's memory taken.
    import subprocess

    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, os.path.join(repo_root, "bench.py")]
    cmd += ["-n", str(args.n), "-g", str(args.genes), "-k", str(args.k)]
    cmd += ["-s", str(args.samples), "--sweeps", str(args.sweeps)]
    return subprocess.call(cmd)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="trigenicinteractionpredictor_tpu",
        description="MMSBM engine for trigenic interaction prediction",
    )
    subs = parser.add_subparsers(dest="cmd", required=True)

    p_fit = subs.add_parser("fit", help="train on one 80/20 split and evaluate")
    _base_parser(p_fit)
    p_fit.add_argument("--resume", default=None, help="checkpoint to resume from")
    p_fit.set_defaults(fn=cmd_fit)

    p_cv = subs.add_parser("cv", help="k-fold cross-validation at fixed K")
    _base_parser(p_cv)
    p_cv.add_argument("--folds", type=int, default=5)
    p_cv.set_defaults(fn=cmd_cv)

    p_sw = subs.add_parser("sweep", help="K-grid sweep with best-L selection")
    _base_parser(p_sw)
    p_sw.add_argument("--k-grid", default="5,10,25,50")
    p_sw.add_argument("--folds", type=int, default=1)
    p_sw.set_defaults(fn=cmd_sweep)

    p_pr = subs.add_parser("predict", help="score triplets from a checkpoint")
    _base_parser(p_pr)
    p_pr.add_argument("--checkpoint", required=True)
    p_pr.set_defaults(fn=cmd_predict)

    p_an = subs.add_parser(
        "analyze", help="cross-restart agreement/stability report from a checkpoint"
    )
    p_an.add_argument("--checkpoint", required=True)
    p_an.add_argument(
        "-f", "--file", default=None,
        help="optional probe dataset (TSV or .npz) for score agreement + AUC",
    )
    p_an.add_argument("-o", "--out", default=None, help="output JSON path")
    p_an.add_argument("--tau-mode", choices=["abs", "negative"], default="abs")
    p_an.add_argument("--p-cutoff", type=float, default=0.05)
    p_an.add_argument("--tau-cutoff", type=float, default=0.08)
    p_an.add_argument(
        "--mutant-type", choices=["trigenic", "digenic"], default="trigenic"
    )
    p_an.set_defaults(fn=cmd_analyze)

    p_sy = subs.add_parser("synth", help="generate a synthetic packed dataset")
    p_sy.add_argument("-o", "--out", required=True)
    p_sy.add_argument("-n", type=int, default=100_000)
    p_sy.add_argument("-g", "--genes", type=int, default=1000)
    p_sy.add_argument("-k", type=int, default=10)
    p_sy.add_argument("--ratings", type=int, default=2)
    p_sy.add_argument(
        "--arity", type=int, choices=[2, 3], default=3,
        help="genes per observation: 3 (trigenic) or 2 (digenic pairs)",
    )
    p_sy.add_argument("--seed", type=int, default=0)
    p_sy.add_argument("--ground-truth", default=None, help=".npz for (theta*, p*)")
    p_sy.set_defaults(fn=cmd_synth)

    p_vp = subs.add_parser(
        "verify-parity",
        help="parity-readiness gate: reference-mount status, loader "
        "fingerprint, and a reference-comparable converged artifact "
        "(docs/PARITY.md)",
    )
    _base_parser(p_vp)
    p_vp.add_argument(
        "--no-fit", action="store_true",
        help="fingerprint only; skip the training/artifact stage",
    )
    p_vp.set_defaults(fn=cmd_verify_parity)

    p_be = subs.add_parser("bench", help="run the repo benchmark")
    p_be.add_argument("-n", type=int, default=131072, help="triplets")
    p_be.add_argument("-g", "--genes", type=int, default=1000)
    p_be.add_argument("-k", type=int, default=10)
    p_be.add_argument("-s", "--samples", type=int, default=10)
    p_be.add_argument("--sweeps", type=int, default=120)
    p_be.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    from trigenicinteractionpredictor_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
