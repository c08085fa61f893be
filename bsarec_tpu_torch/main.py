"""Flag-compatible CLI entry (counterpart of `bsarec_tpu/main.py`).

    python -m bsarec_tpu_torch.main --data_name Beauty --model_type BSARec \
        --c 5 --alpha 0.7 --lr 0.0005 --train_name BSARec_Beauty
    python -m bsarec_tpu_torch.main --data_name Beauty --model_type BSARec \
        --c 5 --alpha 0.7 --do_eval --load_model BSARec_Beauty
    BSAREC_DROPOUT=pallas python -m bsarec_tpu_torch.main --data_name Beauty \
        --model_type SASRec --prng rbg --train_name SASRec_Beauty
    python -m bsarec_tpu_torch.main --data_name Beauty --model_type FEARec \
        --train_name FEARec_Beauty

Takes the JAX CLI's flags plus `--device` (default cuda; CUDA asked for
and absent raises, `--device cpu` runs on the CPU). Every `--model_type`
of the JAX package is ported: BSARec, SASRec, BERT4Rec, FMLPRec, GRU4Rec,
Caser, DuoRec and FEARec, each with its own flags; an unknown type
raises. `--prng rbg` with
`BSAREC_DROPOUT=pallas` runs every dropout site on the fused kernel. Without `--do_eval`
it trains (`Trainer.fit`: epochs, validation, early stopping with a
checkpoint of the best model, a train-state snapshot after each epoch,
the final test); `--resume` continues from the snapshot. With
`--do_eval` it loads `--load_model` (a port checkpoint) or
`--load_torch_model` (a reference torch state_dict, the same key layout;
a pre-rename BSARec checkpoint's `filter_layer.beta` is read as
`sqrt_beta`) and runs the test split. Either way `--export_topk` then writes the
[num_users, 20] top-k ids, and `--export_serving scorer.pt2` the
weights-baked serving artifact (`serving.py`; `--serving_quant`,
`--serving_impl`, `--serving_item_chunk`), exported on `--device`; serve
it with `python -m bsarec_tpu_torch.serve scorer.pt2`. `--dump_seqout
<dir>` writes the per-layer sequence outputs of the test inputs
(`<dir>/<data_name>_<model_type>/{L}layer_{i}iter.npy`), `--profile <dir>`
traces `Trainer.fit` with torch.profiler into `<dir>`, and `--remat`
recomputes each step's whole loss in its backward. `--dtype bf16`
runs all of it under the bf16 compute policy (`ops/precision.py`): the
streaming CE kernels in their bf16-operand form, the dense eval and the
scorer on bf16-rounded operands.

`--mesh data:N,model:M` runs all of it on a ("data", "model") mesh over
`torch.distributed` (`core/mesh.py`), one process a rank: batches split
over "data", the item table's rows over "model". Launch the ranks with
`torchrun --nproc_per_node N*M -m bsarec_tpu_torch.main --mesh ...`
(one rank a card; `--device cpu` for gloo ranks on the CPU); without the
launcher's environment it forms a one-rank group. Rank 0 writes the log
and every file (checkpoints, snapshots, `--export_topk`,
`--export_serving`, `--dump_seqout`, the `--profile` trace), each with
the full table, as a single run writes them.

`--multihost` keeps the training set on the host (`data/multihost.py`):
each step moves a data rank's rows of the global batch to its device, in
the device-resident run's order, so the run's numbers are that run's.
Alone it is one process, a single run (JAX's `main` would train each
process of a launcher on its own rows with no gradient sync); with
`--mesh` each rank of the mesh feeds its data rank's rows.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch.distributed as dist

from bsarec_tpu_torch.config import ModelConfig, TrainConfig, resolve_device
from bsarec_tpu_torch.core import mesh as meshlib
from bsarec_tpu_torch.data.corpus import load_corpus
from bsarec_tpu_torch.data.pipeline import SeqRecData
from bsarec_tpu_torch.train import checkpoint as ckpt
from bsarec_tpu_torch.train.trainer import Trainer
from bsarec_tpu_torch.utils.logging import get_local_time, set_logger
from bsarec_tpu_torch.utils.profiling import trace

def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    # basic
    parser.add_argument("--data_dir", default="data/", type=str)
    parser.add_argument("--output_dir", default="output/", type=str)
    parser.add_argument("--data_name", default="Beauty", type=str)
    parser.add_argument("--do_eval", action="store_true")
    parser.add_argument("--load_model", default=None, type=str)
    parser.add_argument("--load_torch_model", default=None, type=str,
                        help="path to a reference PyTorch .pt state-dict")
    parser.add_argument("--export_topk", default=None, type=str,
                        help="write the [num_users, 20] seen-masked top-k item ids "
                        "of the test split to this .npy path")
    parser.add_argument("--dump_seqout", default=None, type=str,
                        help="write reference-layout per-layer sequence-output dumps "
                        "(<dir>/<data>_<model>/{L}layer_{i}iter.npy, the figure3.ipynb "
                        "input format) from the final/test model to this directory")
    parser.add_argument("--export_serving", default=None, type=str,
                        help="export the weights-baked, batch-polymorphic top-k scorer "
                        "(torch.export .pt2) to this path; load it with "
                        "bsarec_tpu_torch.serving.load_scorer, serve it with "
                        "python -m bsarec_tpu_torch.serve")
    parser.add_argument("--serving_quant", default="none", choices=["none", "int8"],
                        help="with --export_serving: symmetric per-row int8 catalog matmul")
    parser.add_argument("--serving_impl", default="bitmask",
                        choices=["bitmask", "dense", "filtered", "chunked"],
                        help="with --export_serving: the masking layout, all giving the same "
                        "ranking. 'bitmask' (default) runs the streaming rank kernel in its "
                        "serving mode (no [b, V] scores); 'dense' masks the [b, V] logits; "
                        "'filtered' masks in top-k space; 'chunked' streams the catalog in "
                        "--serving_item_chunk blocks")
    parser.add_argument("--serving_item_chunk", default=65536, type=int)
    parser.add_argument("--train_name", default=get_local_time(), type=str)
    parser.add_argument("--profile", default=None, type=str,
                        help="write a torch.profiler trace of the run to this directory")
    parser.add_argument("--resume", action="store_true",
                        help="continue training from the <train_name>.ckpt.state snapshot")
    parser.add_argument("--mesh", default="", type=str,
                        help="'data:N,model:M' or 'auto': a (data, model) mesh over the ranks of "
                        "the torch.distributed group (torchrun's environment, else one rank): "
                        "batches over data, item-table rows over model")
    parser.add_argument("--prng", default="threefry", choices=("threefry", "rbg"),
                        help="rbg with BSAREC_DROPOUT=pallas in the environment runs every "
                        "dropout site on the fused CUDA kernel (Philox in the kernel, the "
                        "mask made again in the backward); otherwise torch's nn.Dropout")
    parser.add_argument("--multihost", action="store_true",
                        help="host-fed input pipeline (training set stays on host; "
                        "required when no single host holds the full dataset). Without --mesh "
                        "one process, a single run; with --mesh each rank feeds its data "
                        "rank's rows of every batch")
    parser.add_argument("--eval_impl", default="auto", type=str,
                        help="full-catalog eval path: auto | dense | streaming (under a "
                        "vocab-sharded --mesh: their sharded forms)")
    parser.add_argument("--dtype", default="fp32", type=str,
                        help="compute dtype policy: fp32 (reference-exact) | bf16 (bf16 "
                        "operands in the dense, attention and CE matmuls; fp32 parameters, "
                        "LayerNorm, softmax and loss accumulation)")
    parser.add_argument("--device", default="cuda", type=str,
                        help="cuda (default) or cpu; asking for cuda without a card raises")
    # drop-in compatibility no-ops (reference `src/utils.py:58-78`)
    parser.add_argument("--num_items", default=10, type=int, help="(compat no-op)")
    parser.add_argument("--num_users", default=10, type=int, help="(compat no-op)")
    parser.add_argument("--no_cuda", action="store_true", help="(compat no-op)")
    parser.add_argument("--num_workers", default=4, type=int, help="(compat no-op)")
    parser.add_argument("--gpu_id", default="0", type=str, help="(compat no-op)")
    parser.add_argument("--variance", default=5, type=float, help="(compat no-op)")
    # train
    parser.add_argument("--lr", default=0.001, type=float)
    parser.add_argument("--batch_size", default=256, type=int)
    parser.add_argument("--epochs", default=200, type=int)
    parser.add_argument("--log_freq", default=1, type=int)
    parser.add_argument("--patience", default=10, type=int)
    parser.add_argument("--seed", default=42, type=int)
    parser.add_argument("--weight_decay", default=0.0, type=float)
    parser.add_argument("--adam_beta1", default=0.9, type=float)
    parser.add_argument("--adam_beta2", default=0.999, type=float)
    # model
    parser.add_argument("--model_type", default="BSARec", type=str)
    parser.add_argument("--max_seq_length", default=50, type=int)
    parser.add_argument("--hidden_size", default=64, type=int)
    parser.add_argument("--num_hidden_layers", default=2, type=int)
    parser.add_argument("--hidden_act", default="gelu", type=str)
    parser.add_argument("--num_attention_heads", default=2, type=int)
    parser.add_argument("--attention_probs_dropout_prob", default=0.5, type=float)
    parser.add_argument("--hidden_dropout_prob", default=0.5, type=float)
    parser.add_argument("--initializer_range", default=0.02, type=float)
    parser.add_argument("--scan_unroll", default=0, type=int,
                        help="(the JAX epoch scan's unroll; no counterpart in the port)")
    parser.add_argument("--remat", action="store_true",
                        help="whole-loss rematerialization in the backward "
                        "(torch.utils.checkpoint of each step's loss): ~1/3 more FLOPs; "
                        "no activation is kept between the forward and the backward, "
                        "though the backward's peak memory need not fall")

    args, _ = parser.parse_known_args(argv)
    mt = args.model_type.lower()
    if mt == "bsarec":
        parser.add_argument("--c", default=3, type=int)
        parser.add_argument("--alpha", default=0.9, type=float)
    elif mt == "bert4rec":
        parser.add_argument("--mask_ratio", default=0.2, type=float)
    elif mt == "caser":
        parser.add_argument("--nh", default=8, type=int)
        parser.add_argument("--nv", default=4, type=int)
        parser.add_argument("--reg_weight", default=1e-4, type=float)
    elif mt in ("duorec", "fearec"):
        parser.add_argument("--tau", default=1.0, type=float)
        parser.add_argument("--lmd", default=0.1, type=float)
        parser.add_argument("--lmd_sem", default=0.1, type=float)
        parser.add_argument("--ssl", default="us_x", type=str)
        parser.add_argument("--sim", default="dot", type=str)
        if mt == "fearec":
            parser.add_argument("--spatial_ratio", default=0.1, type=float)
            parser.add_argument("--global_ratio", default=0.6, type=float)
            parser.add_argument("--fredom_type", default="us_x", type=str)
            parser.add_argument("--fredom", default="True", type=str)
    elif mt == "gru4rec":
        parser.add_argument("--gru_hidden_size", default=64, type=int)
    return parser.parse_args(argv)


def configs_from_args(args, item_size: int, num_users: int):
    model_fields = set(ModelConfig.__dataclass_fields__)
    overrides = {k: v for k, v in vars(args).items() if k in model_fields}
    if isinstance(overrides.get("fredom"), str):
        overrides["fredom"] = overrides["fredom"] == "True"
    dtype_names = {"fp32": "float32", "bf16": "bfloat16",
                   "float32": "float32", "bfloat16": "bfloat16"}
    overrides["compute_dtype"] = dtype_names[args.dtype]
    model_cfg = ModelConfig(**overrides | {"item_size": item_size, "num_users": num_users})
    train_cfg = TrainConfig(
        lr=args.lr, batch_size=args.batch_size, epochs=args.epochs, patience=args.patience,
        seed=args.seed, weight_decay=args.weight_decay, adam_beta1=args.adam_beta1,
        adam_beta2=args.adam_beta2, log_freq=args.log_freq, eval_impl=args.eval_impl,
        mesh=args.mesh, multihost=args.multihost, scan_unroll=args.scan_unroll,
        remat=args.remat, device=args.device, prng=args.prng,
    )
    return model_cfg, train_cfg


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)  # a missing card fails before the data is read
    made_group = bool(args.mesh) and not dist.is_initialized()
    if args.mesh:
        meshlib.init_process_group(device.type)
    try:
        return _run(args)
    finally:
        if made_group and dist.is_initialized():
            dist.destroy_process_group()


def _quiet_logger() -> logging.Logger:
    """The logger of a rank that writes no log (every rank but 0 of a mesh)."""
    logger = logging.getLogger("seqrec.quiet")
    logger.handlers[:] = [logging.NullHandler()]
    logger.propagate = False
    return logger


def _run(args):
    writer = not args.mesh or dist.get_rank() == 0
    os.makedirs(args.output_dir, exist_ok=True)
    logger = (set_logger(os.path.join(args.output_dir, args.train_name + ".log")) if writer
              else _quiet_logger())

    corpus = load_corpus(os.path.join(args.data_dir, args.data_name + ".txt"))
    data = SeqRecData(corpus, args.max_seq_length)
    model_cfg, train_cfg = configs_from_args(args, corpus.item_size, corpus.num_users + 1)
    logger.info(str(vars(args)))

    checkpoint_path = os.path.join(args.output_dir, args.train_name + ".ckpt")
    trainer = Trainer(model_cfg, train_cfg, data, logger, checkpoint_path)

    if not args.do_eval:
        start_epoch = trainer.resume() if args.resume else 0
        with trace(args.profile if writer else None, trainer.device):
            scores, result_info = trainer.fit(start_epoch)
    elif args.load_torch_model is not None:
        trainer.install_params(ckpt.load_reference_params(args.load_torch_model))
        logger.info(f"Imported torch checkpoint {args.load_torch_model} for test!")
        scores, result_info = trainer.test(0)
    elif args.load_model is None:
        logger.info("No model input!")
        return None
    else:
        trainer.load(os.path.join(args.output_dir, args.load_model + ".ckpt"))
        logger.info(f"Load model from {args.load_model} for test!")
        scores, result_info = trainer.test(0)

    if args.export_topk:
        topk = trainer.export_topk("test")
        if writer:
            np.save(args.export_topk, topk)
        logger.info(f"exported top-{topk.shape[1]} item ids for "
                    f"{topk.shape[0]} users to {args.export_topk}")

    if args.dump_seqout:
        tag = f"{args.data_name}_{args.model_type}"
        n = trainer.dump_sequence_outputs(args.dump_seqout, tag)
        logger.info(f"dumped {n} per-layer sequence-output batches to "
                    f"{os.path.join(args.dump_seqout, tag)}")

    if args.export_serving:
        from bsarec_tpu_torch.serving import export_scorer

        full = trainer.full_model()
        if writer:
            meta = export_scorer(
                full, model_cfg.item_size, args.max_seq_length,
                data.test.seen_items.shape[1], args.export_serving,
                quant=None if args.serving_quant == "none" else args.serving_quant,
                impl=args.serving_impl, item_chunk=args.serving_item_chunk,
                dtype=model_cfg.compute_dtype,
            )
            logger.info(f"exported serving scorer: {meta}")
        if args.mesh:
            dist.barrier()

    logger.info(args.train_name)
    logger.info(result_info)
    return scores


if __name__ == "__main__":
    main()
