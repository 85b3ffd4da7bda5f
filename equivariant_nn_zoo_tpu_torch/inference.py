"""Batch inference: run a model over padded batches and keep real graphs.

    python -m equivariant_nn_zoo_tpu_torch.inference --config config_energy \
        --model_path results/default_project/default/best.pt \
        --output_path inference.hdf5 --output_keys total_energy

PyTorch counterpart of the repository's ``inference.py``: ``evaluate`` is
its evaluation loop as a library function, ``main`` its command line on
``argparse`` (the same flags, and ``--device``: ``cuda`` unless the caller
asks for ``cpu``).  ``main`` loads a ``trainer.pt``, ``best.pt`` or
``last.pt`` of either package, or a diffusion checkpoint, evaluates the
config's dataset in batches (the last one padded, its real graphs kept),
writes the outputs to HDF5 through the port's own writer
(``data/hdf5.py``, no ``h5py``) and returns them.
"""

from __future__ import annotations

import argparse
import logging
from typing import Iterable, Sequence

import torch

from .data.batch import Batch
from .data.graph_batch import GraphBatch


def evaluate(model: torch.nn.Module, batches: Iterable[GraphBatch],
             output_keys: Sequence[str] = ()) -> Batch:
    """Forward every batch under ``torch.no_grad()`` and return one host
    ``Batch`` of the real graphs (``_graph_mask``), with the requested
    outputs (all public annotated keys when ``output_keys`` is empty);
    node outputs such as ``forces`` keep the real nodes.  Not
    ``inference_mode``: a force head differentiates the energy inside the
    forward, and tensors made in inference mode cannot enter autograd."""
    results = []
    keys = list(output_keys)
    with torch.no_grad():
        for gb in batches:
            out = model(gb)
            if not keys:
                keys = [k for k in out.keys()
                        if k in out.attrs and not k.startswith("_")]
            # copy to the host only what is returned; to_batch() drops the
            # padded nodes, edges and graphs (real graphs are a prefix)
            wanted = set(keys) | {"_n_nodes", "_node_mask", "_edge_mask",
                                  "_graph_mask"}
            host = GraphBatch(
                {k: v for k, v in out.data.items() if k in wanted},
                out.attrs, out.n_graphs, out.node_capacity,
                out.edge_capacity).to_batch()
            keep = {k: host[k] for k in keys if k in host.keys()}
            keep["_n_nodes"] = host["_n_nodes"]
            attrs = {k: host.attrs[k] for k in keep if k in host.attrs}
            results.append(Batch(attrs, **keep))
    return Batch.from_data_list(results)


def parse_args(argv=None) -> argparse.Namespace:
    """The JAX CLI's flags (``inference.py:12-21``) and ``--device``."""
    p = argparse.ArgumentParser(
        prog="python -m equivariant_nn_zoo_tpu_torch.inference",
        description="Evaluate a trained model over a config's dataset.")
    add = p.add_argument
    add("--config", required=True, help="The name of the config.")
    add("--config_spec", default="", help="Config specification.")
    add("--model_path", default=None, help="Path of the model checkpoint.")
    add("--output_path", default="inference.hdf5", help="Output HDF5 path.")
    add("--output_keys", default="",
        help="Comma-separated output keys to dump.")
    add("--seed", type=int, default=0, help="The RNG seed.")
    add("--batch_size", type=int, default=0,
        help="Override the config's batch size.")
    add("--equivariance_test", action=argparse.BooleanOptionalAction,
        default=False, help="Fill the dataset with rotated copies first.")
    add("--verbose", default="INFO", help="Logging verbosity.")
    add("--device", default="cuda", choices=("cuda", "cpu"),
        help="cuda (default) or cpu.")
    return p.parse_args(argv)


def model_params(tree):
    """The parameter tree of a checkpoint: a ``trainer.pt``'s
    ``model_params``, a diffusion state's ``params``, or the tree itself
    (``best.pt``, ``last.pt``)."""
    if isinstance(tree, dict) and "model_params" in tree:
        tree = tree["model_params"]
    if isinstance(tree, dict) and "params" in tree and "step" in tree:
        tree = tree["params"]
    return tree


def main(argv=None) -> Batch:
    """Evaluate ``--config``'s dataset with the weights of
    ``--model_path`` (the seeded initial weights without one), dump the
    outputs to ``--output_path`` (a failure to write raises), and return
    them as one host ``Batch`` of the real graphs."""
    from .data.dataloader import DataLoader
    from .data.dataset import CondensedDataset
    from .models import build_model, get_config
    from .utils import load_file, load_jax_params, pruneArgs

    args = parse_args(argv)
    logging.basicConfig(level=getattr(logging, args.verbose.upper(),
                                      logging.INFO))
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch.cuda.is_available() is "
                           "false; pass --device cpu to run on the CPU")
    config = get_config(args.config, args.config_spec or None)
    model = build_model(config["model_config"], args.device,
                        torch.Generator().manual_seed(args.seed))
    if args.model_path:
        load_jax_params(model, model_params(
            load_file(args.model_path, enforced_format="pickle")))
    model.eval()

    dataset = CondensedDataset(
        **pruneArgs(CondensedDataset, **dict(config["data_config"])))
    if args.equivariance_test:
        dataset.equivarianceTest(config["batch_size"])
    batch_size = args.batch_size or config["batch_size"]
    loader = DataLoader(dataset, batch_size=batch_size, shuffle=False,
                        drop_last=False, pin_memory=args.device == "cuda")
    merged = evaluate(model, (gb.to(args.device) for gb in loader),
                      [k for k in args.output_keys.split(",") if k])
    merged.dumpHDF5(args.output_path)
    logging.info(f"Wrote {len(merged)} graphs to {args.output_path}")
    return merged


if __name__ == "__main__":
    main()
