"""Command-line entry points (counterpart of
``image_restoration_agent_tpu/cli.py``, the same subcommands and flags).

- ``python -m image_restoration_agent_tpu_torch.cli infer <image> [-o
  out_dir]`` runs the IRAgent (reference: python -m pipeline.infer,
  do_test.sh).
- ``... serve [--port 1146]`` starts the agent HTTP API
  (reference agentic_api.py on :1146).
- ``... eval-service [--port 6006]`` starts the DepictQA-contract evaluation
  service.
- ``... restore <image> --model <name> -o out.png`` one model, one image.
- ``... test-tools`` smoke-runs every registered tool with the x1/x4 shape
  check (reference test_tool/test_tool.py + test_env.sh).
- ``... warmup`` builds the CUDA kernels and walks each (model, size)
  through the serving path before traffic arrives.
- ``... insert-runs <output_dir> [--store retrieval_store.npz]`` embeds the
  input of every solved agent run under ``output_dir`` into the retrieval
  store (``default_embedder``: CLIP RN50x4 + Combiner where their weights
  are in the port's ``weights/``, else the stand-in), creating the store
  or adding to it; the file is the JAX package's format.

- ``... score <result_dir> <gt_dir>`` scores every result image against
  its same-named ground truth (PSNR, SSIM).
- ``... convert-weights <model> --ckpt <file>`` converts a downloaded
  reference checkpoint into the port's weight file ``<out>/<model>.npz``
  (a reference-named state dict; ``list`` prints the manifest, no
  ``--ckpt`` the entry).
- ``... validate-weights <ckpt_dir>`` converts every manifest entry found
  there and runs each family on a fixture or its golden;
  ``--synthetic`` runs the committed real-geometry synthetic goldens
  through the same converter.
- ``... eval-suite`` runs the agent over the 16 degradation combos and
  ``... ablation-grid`` over the retrieval / reflection / rollback
  variants, writing markdown and JSON reports.

Every subcommand that builds an engine, a scorer, an evaluator or an
embedder takes ``--device``: ``cuda`` (the default; it raises without a
card) or ``cpu``.

``infer --evaluate-by clip_retrieval`` builds the agent without a
retrieval store, as the JAX CLI does, so it fails on ``None.embed`` (a
reference fault, pinned in ``tests/test_torch_retrieval.py``).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

def parse_sizes(spec: str) -> list[tuple[int, int]]:
    """'256,512x768,720p' -> [(256, 256), (768, 512), (720, 1280)];
    WxH order matches bench.py's --size, returned as (H, W)."""
    named = {"720p": (720, 1280), "1080p": (1080, 1920),
             "2k": (1080, 1920), "4k": (2160, 3840)}
    out = []
    for tok in spec.split(","):
        tok = tok.strip().lower()
        if not tok:
            continue
        if tok in named:
            out.append(named[tok])
        elif "x" in tok:
            w, h = (int(v) for v in tok.split("x"))
            out.append((h, w))
        else:
            out.append((int(tok), int(tok)))
    return out


def _device_arg(parser) -> None:
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where models run (cuda raises without a "
                             "card; cpu runs the kernels' plain versions)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="image_restoration_agent_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("infer", help="run the full agent on one image")
    pi.add_argument("image")
    pi.add_argument("-o", "--output-dir", default="output")
    pi.add_argument("--fast", action="store_true",
                    help="tiny models (CPU smoke)")
    pi.add_argument("--evaluate-by", default="local",
                    choices=["local", "gpt4v", "clip_retrieval"])
    pi.add_argument("--no-reflection", action="store_true")
    pi.add_argument("--no-rollback", action="store_true")
    _device_arg(pi)

    ps = sub.add_parser("serve", help="start the agent HTTP API")
    ps.add_argument("--host", default="0.0.0.0")
    ps.add_argument("--port", type=int, default=1146)
    ps.add_argument("--work-root", default="api_work")
    ps.add_argument("--fast", action="store_true")
    _device_arg(ps)

    pe = sub.add_parser("eval-service",
                        help="DepictQA-contract evaluation service")
    pe.add_argument("--host", default="127.0.0.1")
    pe.add_argument("--port", type=int, default=6006)
    _device_arg(pe)

    pr = sub.add_parser("restore", help="run one model on one image")
    pr.add_argument("image")
    pr.add_argument("--model", required=True)
    pr.add_argument("-o", "--output", default="output.png")
    pr.add_argument("--tile", type=int, default=None)
    _device_arg(pr)

    pt = sub.add_parser("test-tools", help="smoke-test every tool")
    pt.add_argument("--fast", action="store_true", default=True)
    pt.add_argument("--work-dir", default="/tmp/ira_tool_test")
    _device_arg(pt)

    psc = sub.add_parser("score", help="batch-score results vs ground truth")
    psc.add_argument("result_dir")
    psc.add_argument("gt_dir")
    psc.add_argument("-o", "--output", default=None)
    _device_arg(psc)

    pir = sub.add_parser("insert-runs",
                         help="embed solved agent runs into the retrieval "
                              "store")
    pir.add_argument("output_dir", help="agent output dir with run subdirs")
    pir.add_argument("--store", default="retrieval_store.npz")
    _device_arg(pir)

    pw = sub.add_parser(
        "convert-weights",
        help="convert a downloaded reference checkpoint to the port's "
             "weight file (<out>/<model>.npz)")
    pw.add_argument("model", help="registry/manifest name, or 'list'")
    pw.add_argument("--ckpt", help="path to the downloaded checkpoint")
    pw.add_argument("--out", default="weights",
                    help="weight root (engine weight_dir)")

    pvw = sub.add_parser(
        "validate-weights",
        help="one-command real-checkpoint gate: convert every manifest "
             "entry found in a checkpoint dir, run each family on a "
             "fixture, score vs stored goldens")
    pvw.add_argument("ckpt_dir", nargs="?", default=None,
                     help="directory of downloaded checkpoints "
                          "(omit with --synthetic)")
    pvw.add_argument("--out", default="weights",
                     help="weight root (engine weight_dir)")
    pvw.add_argument("--models", default=None,
                     help="comma-separated subset of manifest models")
    pvw.add_argument("--synthetic", action="store_true",
                     help="run the committed synthetic real-geometry "
                          "goldens (no downloaded weights needed): rebuild "
                          "each deterministic .pth, convert through the "
                          "manifest, serve, gate PSNR at 0.1 dB")
    _device_arg(pvw)

    pwu = sub.add_parser(
        "warmup",
        help="build the CUDA kernels and walk each (model, size) through "
             "the serving path so first-request latency is bounded "
             "(reference analog: pre-launching every model service before "
             "traffic, AgentApp/test_env.sh); the kernels' build directory "
             "survives restarts")
    pwu.add_argument("--models", default="nafnet,restormer,swinir_sr_x4",
                     help="comma-separated registry models")
    pwu.add_argument("--sizes", default="256,512",
                     help="comma-separated WxH / single ints (squares) / "
                          "720p / 1080p")
    pwu.add_argument("--weight-dir", default=None,
                     help="weight root (omit: random-init warmup — the "
                          "build and plan cost is weight-independent)")
    pwu.add_argument("--cache-dir", default=None,
                     help="the JAX CLI's XLA cache flag; accepted and "
                          "unused: the port's persistent cache is the "
                          "kernels' build directory (csrc/build/)")
    pwu.add_argument("--ensemble", action="store_true",
                     help="also warm the geometric self-ensemble pipelines")
    _device_arg(pwu)

    pab = sub.add_parser(
        "ablation-grid",
        help="run the retrieval/reflection/rollback ablation grid "
             "(the reference's compare_methods analysis artifact)")
    pab.add_argument("--work-dir", default="ablation_work")
    pab.add_argument("--combos", type=int, default=4)
    pab.add_argument("--images-per-combo", type=int, default=1)
    pab.add_argument("--fast", action="store_true", default=True)
    _device_arg(pab)

    pv = sub.add_parser("eval-suite",
                        help="run the 16-combo agent benchmark")
    pv.add_argument("--work-dir", default="eval_suite_work")
    pv.add_argument("--combos", type=int, default=16,
                    help="how many of the 16 combos to run")
    pv.add_argument("--images-per-combo", type=int, default=1)
    pv.add_argument("--fast", action="store_true", default=True)
    _device_arg(pv)
    return p


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)

    if args.cmd == "infer":
        from .agent import IRAgent, build_default_executor

        agent = IRAgent(
            Path(args.image), Path(args.output_dir),
            executor=build_default_executor(fast=args.fast,
                                            device=args.device),
            evaluate_degradation_by=args.evaluate_by,
            with_reflection=not args.no_reflection,
            with_rollback=not args.no_rollback,
            silent=False, device=args.device,
        )
        result = agent.run()
        print(json.dumps({"result": str(result),
                          "work_dir": str(agent.work_dir)}))
    elif args.cmd == "serve":
        from .agent.executor import build_default_executor
        from .api import make_server
        from .engine import Engine

        eng = Engine(device=args.device)
        srv = make_server(host=args.host, port=args.port,
                          work_root=Path(args.work_root),
                          engine_status=eng.status, device=args.device,
                          executor=build_default_executor(
                              engine=eng, fast=args.fast))
        print(f"agent API on {args.host}:{srv.server_address[1]}")
        srv.serve_forever()
    elif args.cmd == "eval-service":
        from .api.eval_service import make_eval_server

        srv = make_eval_server(args.host, args.port, device=args.device)
        print(f"eval service on {args.host}:{srv.server_address[1]}")
        srv.serve_forever()
    elif args.cmd == "restore":
        from .engine import Engine

        eng = Engine(device=args.device)
        res = eng.restore_file(args.image, args.output, args.model,
                               tile=args.tile or "auto")
        print(json.dumps({"output": str(args.output),
                          "seconds": round(res.seconds, 3),
                          "shape": list(res.output_shape)}))
    elif args.cmd == "insert-runs":
        from .retrieval import NumpyVectorStore, default_embedder
        from .train.retrieval import insert_solved_runs

        emb = default_embedder(device=args.device)
        store_path = Path(args.store)
        store = (NumpyVectorStore.load(store_path, embedder=emb)
                 if store_path.exists()
                 else NumpyVectorStore(dim=640, embedder=emb))
        n = insert_solved_runs(Path(args.output_dir), store, emb)
        store.save(store_path)
        print(json.dumps({"inserted": n, "total": len(store),
                          "store": str(store_path)}))
    elif args.cmd == "warmup":
        from .engine import Engine
        from .ops import kernels

        built = None
        if args.device == "cuda":  # the kernels run on the card only
            built = sorted(kernels.build_all())
        eng = Engine(weight_dir=Path(args.weight_dir)
                     if args.weight_dir else None,
                     allow_random_init=args.weight_dir is None,
                     device=args.device)
        records = eng.warmup(args.models.split(","),
                             parse_sizes(args.sizes),
                             ensemble=args.ensemble)
        print(json.dumps({"records": records,
                          "total_seconds": round(sum(r["seconds"]
                                                     for r in records), 3),
                          "kernels_built": built,
                          "cache_dir": str(kernels.BUILD_DIR)}))
    elif args.cmd == "score":
        from .offline import compute_scores

        out = compute_scores(Path(args.result_dir), Path(args.gt_dir),
                             Path(args.output) if args.output else None,
                             device=args.device)
        print(json.dumps({"mean": out["mean"], "n": out["n"]}))
    elif args.cmd == "convert-weights":
        from .convert.manifest import MANIFEST, convert_checkpoint, get_entry

        if args.model == "list":
            for e in MANIFEST:
                print(f"{e.model:22s} {e.ckpt_file:55s} {e.source}")
        else:
            entry = get_entry(args.model)
            if not args.ckpt:
                print(json.dumps({
                    "model": entry.model, "ckpt_file": entry.ckpt_file,
                    "source": entry.source, "rules": entry.rules,
                    "notes": entry.notes}))
            else:
                out = convert_checkpoint(args.model, args.ckpt, args.out)
                print(json.dumps({"weights_file": str(out)}))
    elif args.cmd == "validate-weights":
        if args.synthetic:
            from .offline.synthetic_goldens import validate_synthetic

            report = validate_synthetic(
                names=args.models.split(",") if args.models else None,
                device=args.device)
            print(json.dumps(report))
            return 1 if report["failed"] else 0
        if not args.ckpt_dir:
            p.error("ckpt_dir is required unless --synthetic is given")
        from .offline.validate_weights import validate

        report = validate(
            Path(args.ckpt_dir), Path(args.out),
            models=args.models.split(",") if args.models else None,
            device=args.device)
        print(json.dumps({k: report[k] for k in
                          ("pass", "converted_aux", "failed", "missing")}))
        return 1 if report["failed"] else 0
    elif args.cmd == "ablation-grid":
        from .offline.benchmark_suite import ALL_COMBOS
        from .offline.eval_harness import run_ablation_grid

        grid = run_ablation_grid(Path(args.work_dir),
                                 combos=ALL_COMBOS[: args.combos],
                                 images_per_combo=args.images_per_combo,
                                 fast=args.fast, device=args.device)
        print(json.dumps({"variants": grid["variants"],
                          "pairs": grid["pairs"],
                          "report": str(Path(args.work_dir)
                                        / "ablation_grid.md")}))
    elif args.cmd == "eval-suite":
        from .offline.benchmark_suite import ALL_COMBOS, run_suite

        report = run_suite(Path(args.work_dir),
                           combos=ALL_COMBOS[: args.combos],
                           images_per_combo=args.images_per_combo,
                           fast=args.fast, device=args.device)
        print(json.dumps({"mean_input_psnr": report["mean_input_psnr"],
                          "mean_output_psnr": report["mean_output_psnr"],
                          "cases": len(report["records"]),
                          "report": str(Path(args.work_dir) / "report.md")}))
    elif args.cmd == "test-tools":
        import numpy as np

        from .agent.executor import build_default_executor

        ex = build_default_executor(fast=args.fast, device=args.device)
        img = np.random.default_rng(0).random((24, 24, 3)).astype(np.float32)
        report = ex.test_all_tools(img, Path(args.work_dir))
        print(json.dumps(report, indent=2, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
