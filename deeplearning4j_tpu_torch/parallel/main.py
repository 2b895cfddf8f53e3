"""Command line for data-parallel training (the JAX package's
``parallel/main.py``; reference ParallelWrapperMain.java).

Usage:
    python -m deeplearning4j_tpu_torch.parallel.main \\
        --model-path model.zip \\
        --iterator-factory mypkg.mymod:make_iterator \\
        --workers 8 --averaging-frequency 5 --epochs 1 \\
        --output-path trained.zip

``--iterator-factory`` names a ``module:callable`` returning a
DataSetIterator. The model trains on the card (``--device cuda``, the
default) or, with ``--device cpu``, on the CPU; ``--workers N`` puts N
data shards on that device (N CUDA devices where the host has them)."""

from __future__ import annotations

import argparse
import importlib
import sys

import torch


def _load_factory(spec: str):
    mod_name, _, attr = spec.partition(":")
    if not attr:
        raise SystemExit("--iterator-factory must be module:callable")
    return getattr(importlib.import_module(mod_name), attr)


def _shard_devices(device: torch.device, n: int):
    """N data shards: one per CUDA device where the host has N of them,
    else all on ``device`` (several shards may share a device)."""
    if device.type == "cuda" and torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [device] * n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="parallel-wrapper",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--model-path", required=True,
                    help="checkpoint zip saved by ModelSerializer")
    ap.add_argument("--iterator-factory", required=True,
                    help="module:callable returning a DataSetIterator")
    ap.add_argument("--workers", type=int, default=None,
                    help="data shards (default: every CUDA device, or 1 "
                         "on the CPU)")
    ap.add_argument("--averaging-frequency", type=int, default=1)
    ap.add_argument("--no-average-updaters", action="store_true")
    ap.add_argument("--prefetch-buffer", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--output-path", default=None,
                    help="where to save the trained model zip")
    ap.add_argument("--mode", choices=["wrapper", "param-server"],
                    default="wrapper",
                    help="sync / local-steps mesh DP or async "
                         "parameter-server DP")
    ap.add_argument("--push-frequency", type=int, default=1,
                    help="param-server mode: push every N batches")
    ap.add_argument("--device", default="cuda",
                    help="device to train on (default: the card)")
    args = ap.parse_args(argv)

    from ..utils.serializer import ModelGuesser, ModelSerializer
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda but no CUDA device is "
                             "available; pass --device cpu to train on the "
                             "CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    net = ModelGuesser.load_model_guess_type(args.model_path, device=device)
    iterator = _load_factory(args.iterator_factory)()

    if args.mode == "param-server":
        from .param_server import ParameterServerParallelWrapper
        pw = ParameterServerParallelWrapper(
            net, num_workers=args.workers or 2,
            push_frequency=args.push_frequency)
        pw.fit(iterator, num_epochs=args.epochs)
    else:
        from .mesh import make_mesh
        from .wrapper import ParallelWrapper
        n = args.workers or (torch.cuda.device_count()
                             if device.type == "cuda" else 1)
        pw = ParallelWrapper(
            net, mesh=make_mesh(devices=_shard_devices(device, n)),
            averaging_frequency=args.averaging_frequency,
            average_updaters=not args.no_average_updaters,
            prefetch_buffer=args.prefetch_buffer)
        pw.fit(iterator, num_epochs=args.epochs)

    out = args.output_path or args.model_path
    ModelSerializer.write_model(net, out)
    print(f"trained {args.epochs} epoch(s); model saved to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
