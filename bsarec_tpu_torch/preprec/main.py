"""PREPRec CLI for NewRec (counterpart of `bsarec_tpu/preprec/main.py`).

    python -m bsarec_tpu_torch.preprec.main --dataset douban/douban_music \
        --model newrec --data_dir ./data
    python -m bsarec_tpu_torch.preprec.main --dataset <ds> --model newrec \
        --eval_method 3 --device cpu

`parse` takes the JAX CLI's flags, flag for flag; `--device` defaults to
cuda and raises without a card (`--device cpu` runs on the CPU). It
trains NewRec (`PrepRecTrainer.fit`) or, with `--inference_only`,
evaluates the freshly initialised model on `--mode`; `--eval_method 1`
(100 sampled negatives) or 3 (the full catalog), `--sparse`,
`--use_week_eval`, `--eval_quality` and `--save_ranks` work as there.
Checkpoints go to `res/<dataset>/<train_dir>/` as torch state_dicts.
`--prng` is accepted and changes nothing: PREPRec's dropout is
nn.Dropout. The other models and the transfer, score and export flags are
not ported yet and raise (ROADMAP A5b).
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from bsarec_tpu_torch.config import resolve_device
from bsarec_tpu_torch.preprec.config import PrepRecConfig, PrepRecTrainConfig
from bsarec_tpu_torch.preprec.data import load_intwtime, load_userneg
from bsarec_tpu_torch.preprec.models import PREPREC_REGISTRY
from bsarec_tpu_torch.preprec.popularity import EvalPopularity, PopularityEncoding
from bsarec_tpu_torch.preprec.train import PrepRecTrainer

# flags of parts not ported yet (ROADMAP A5b), with their off values
_NOT_PORTED_FLAGS = {
    "transfer": False, "fs_transfer": False, "state_dict_path": None, "dataset2": "",
    "save_scores": False, "use_scores": False, "export_user_embed": False,
    "export_serving": None,
}


def parse(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True)
    p.add_argument("--data_dir", default="./data", type=str)
    p.add_argument("--train_dir", default="test", type=str)
    p.add_argument("--batch_size", default=128, type=int)
    p.add_argument("--lr", default=0.001, type=float)
    p.add_argument("--wd", default=1e-5, type=float)
    p.add_argument("--maxlen", default=200, type=int)
    p.add_argument("--hidden_units", default=50, type=int)
    p.add_argument("--num_blocks", default=2, type=int)
    p.add_argument("--num_epochs", default=80, type=int)
    p.add_argument("--epoch_test", default=4, type=int)
    p.add_argument("--stop_early", default=3, type=int)
    p.add_argument("--num_heads", default=1, type=int)
    p.add_argument("--dropout_rate", default=0.2, type=float)
    p.add_argument("--inference_only", action="store_true")
    p.add_argument("--train_only", action="store_true")
    p.add_argument("--first_eval", action="store_true")
    p.add_argument("--state_override", action="store_true")
    p.add_argument("--l2_emb", default=0.0, type=float)
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (default) or cpu; asking for cuda without a card raises")
    # accepted for drop-in compatibility; no-ops here, as in the JAX CLI
    p.add_argument("--max_split_size", default=-1.0, type=float)
    p.add_argument("--save_neg", action="store_true")
    p.add_argument("--augment", action="store_true")
    p.add_argument("--augfulllen", default=0, type=int)
    p.add_argument("--mode", default="test", type=str)
    p.add_argument("--prev_time", action="store_true")
    p.add_argument("--no_valid_in_test", action="store_true")
    p.add_argument("--state_dict_path", default=None, type=str, help="(not ported yet)")
    p.add_argument("--model", default="newrec", type=str)
    p.add_argument("--monthpop", default="wtembed", type=str)
    p.add_argument("--weekpop", default="week_embed2", type=str)
    p.add_argument("--use_week_eval", action="store_true")
    p.add_argument("--week_eval_pop", default="week_wt_embed_adj", type=str)
    p.add_argument("--rawpop", default="rawpop", type=str)
    p.add_argument("--userpop", default="lastuserpop", type=str)
    p.add_argument("--userneg", default="userneg", type=str)
    p.add_argument("--base_dim1", default=11, type=int)
    p.add_argument("--input_units1", default=132, type=int)
    p.add_argument("--base_dim2", default=6, type=int)
    p.add_argument("--input_units2", default=6, type=int)
    p.add_argument("--mask_prob", default=0.0, type=float)
    p.add_argument("--seed", default=2023, type=int)
    p.add_argument("--topk", "--list", nargs="+", default=[10, 5, 1], type=int)
    p.add_argument("--transfer", action="store_true", help="(not ported yet)")
    p.add_argument("--fs_transfer", action="store_true", help="(not ported yet)")
    p.add_argument("--fs_prop", default=1.0, type=float)
    p.add_argument("--fs_num_epochs", default=80, type=int)
    p.add_argument("--fs_emb", action="store_true")
    p.add_argument("--eval_batch_size", default=0, type=int)
    # full-catalog (eval_method 3) sweep chunk; peak eval memory is
    # O(eval_batch_size * eval_item_chunk), independent of catalog size
    p.add_argument("--eval_item_chunk", default=4096, type=int)
    p.add_argument("--prng", default="threefry", choices=("threefry", "rbg"),
                   help="accepted; changes nothing here (PREPRec's dropout is nn.Dropout)")
    p.add_argument("--loss_size", default=250, type=int)
    p.add_argument("--no_emb", action="store_true")
    p.add_argument("--no_fixed_emb", action="store_true")
    p.add_argument("--eval_method", default=1, type=int)
    p.add_argument("--eval_quality", action="store_true")
    p.add_argument("--quality_size", default=20, type=int)
    p.add_argument("--triplet_loss", action="store_true")
    p.add_argument("--cos_loss", action="store_true")
    p.add_argument("--reg_file", default="userhist", type=str)
    p.add_argument("--reg_num", default=10, type=int)
    p.add_argument("--reg_coef", default=1.0, type=float)
    p.add_argument("--only_reg", action="store_true")
    p.add_argument("--lag", default=1, type=int)
    p.add_argument("--time_embed", action="store_true")
    p.add_argument("--time_no_fixed_embed", action="store_true")
    p.add_argument("--time_embed_concat", action="store_true")
    p.add_argument("--aug_coef", default=0.1, type=float)
    p.add_argument("--sparse", action="store_true")
    p.add_argument("--override_sparse", action="store_true")
    p.add_argument("--sparse_name", default="sparse_", type=str)
    p.add_argument("--time_df_mod", default="", type=str)
    p.add_argument("--save_ranks", action="store_true")
    p.add_argument("--ranks_name", default="ranks", type=str)
    p.add_argument("--not_rank_scores", action="store_true")
    p.add_argument("--dataset2", default="", type=str, help="(not ported yet)")
    p.add_argument("--save_scores", action="store_true", help="(not ported yet)")
    p.add_argument("--use_scores", action="store_true", help="(not ported yet)")
    p.add_argument("--use_score_dir", default="", type=str)
    p.add_argument("--alphas", nargs="+", default=[0.5], type=float)
    p.add_argument("--export_user_embed", "--save_emb", dest="export_user_embed",
                   action="store_true", help="(not ported yet)")
    p.add_argument("--label", default="embed", type=str)
    p.add_argument("--export_serving", default=None, type=str, help="(not ported yet)")
    return p.parse_args(argv)


def refuse_not_ported(args) -> None:
    if args.model not in PREPREC_REGISTRY:
        raise NotImplementedError(
            f"--model {args.model} is not ported yet (ROADMAP A5b); ported: {sorted(PREPREC_REGISTRY)}")
    for flag, off in _NOT_PORTED_FLAGS.items():
        if getattr(args, flag) != off:
            raise NotImplementedError(f"--{flag} is not ported yet (ROADMAP A5b)")


def main(argv=None):
    args = parse(argv)
    refuse_not_ported(args)
    device = resolve_device(args.device)  # a missing card fails before the data is read
    logging.basicConfig(level=logging.INFO, format="%(asctime)s - %(message)s")
    logger = logging.getLogger("preprec")

    prefix = os.path.join(args.data_dir, args.dataset)
    # the reference's file naming: f"{ds}_{sparse_name}intwtime{mod}.csv"
    # when sparse; sparse runs also read the sparse-prefixed popularity files
    sp = args.sparse_name if args.sparse else ""
    stem = f"{sp}intwtime{args.time_df_mod}"
    if args.sparse:
        args.monthpop = sp + args.monthpop
        args.weekpop = sp + args.weekpop
        args.week_eval_pop = sp + args.week_eval_pop
    ds = load_intwtime(f"{prefix}_{stem}.csv", args.maxlen, sparse=args.sparse)

    cfg = PrepRecConfig(
        model=args.model, usernum=ds.usernum, itemnum=ds.itemnum,
        maxlen=args.maxlen, hidden_units=args.hidden_units,
        num_blocks=args.num_blocks, num_heads=args.num_heads,
        dropout_rate=args.dropout_rate, base_dim1=args.base_dim1,
        input_units1=args.input_units1, base_dim2=args.base_dim2,
        input_units2=args.input_units2, lag=args.lag,
        prev_time=args.prev_time, use_week_eval=args.use_week_eval,
        no_emb=args.no_emb, no_fixed_emb=args.no_fixed_emb,
        time_embed=args.time_embed, time_no_fixed_embed=args.time_no_fixed_embed,
        time_embed_concat=args.time_embed_concat, mask_prob=args.mask_prob,
        loss_size=args.loss_size, aug_coef=args.aug_coef,
        triplet_loss=args.triplet_loss, cos_loss=args.cos_loss,
        reg_num=args.reg_num, reg_coef=args.reg_coef, only_reg=args.only_reg,
        eval_method=args.eval_method, topk=tuple(args.topk),
        sparse=args.sparse, override_sparse=args.override_sparse,
        no_valid_in_test=args.no_valid_in_test,
        eval_quality=args.eval_quality, quality_size=args.quality_size,
        fs_emb=args.fs_emb,
    )
    tcfg = PrepRecTrainConfig(
        lr=args.lr, wd=args.wd, batch_size=args.batch_size,
        num_epochs=args.num_epochs, epoch_test=args.epoch_test,
        stop_early=args.stop_early, seed=args.seed, fs_prop=args.fs_prop,
        fs_num_epochs=args.fs_num_epochs,
        eval_batch_size=args.eval_batch_size,
        eval_item_chunk=args.eval_item_chunk, l2_emb=args.l2_emb,
        first_eval=args.first_eval, train_only=args.train_only,
        state_override=args.state_override, device=args.device,
    )

    userpop = None
    if args.eval_quality:
        # user-popularity percentiles for the grouped metrics (the 5 -> 5.5
        # half-split jitter is the reference's amazon_office tie-break)
        userpop = np.loadtxt(f"{prefix}_{args.userpop}.txt").reshape(-1)
        if args.dataset.endswith("amazon_office"):
            jrng = np.random.default_rng(args.seed)
            fives = np.where(userpop == 5)[0]
            userpop[jrng.choice(fives, fives.size // 2, replace=False)] = 5.5

    usernegs = None
    if args.eval_method == 1:
        usernegs = load_userneg(f"{prefix}_{args.userneg}.pickle", ds.usernum)

    pop_enc = PopularityEncoding.load(
        f"{prefix}_{args.monthpop}.txt", f"{prefix}_{args.weekpop}.txt", cfg, device)
    eval_pop = None
    if args.use_week_eval:
        eval_pop = EvalPopularity.load(
            f"{prefix}_{args.monthpop}.txt", f"{prefix}_{args.week_eval_pop}.txt", cfg, device)

    user_feat = None
    if args.triplet_loss or args.cos_loss:
        user_feat = np.loadtxt(f"{prefix}_{args.reg_file}.txt")

    write = os.path.join("res", args.dataset, args.train_dir)
    trainer = PrepRecTrainer(cfg, tcfg, ds, logger, write, pop_enc, eval_pop, usernegs, user_feat)

    if args.inference_only:
        metrics, ranks = trainer.evaluate(args.mode, userpop)
        for (ndcg, hr), k in zip(metrics, cfg.topk):
            logger.info(f"{args.mode} NDCG@{k}: {ndcg}, HR@{k}: {hr}")
    else:
        metrics, ranks = trainer.fit(userpop=userpop)

    if args.save_ranks and ranks is not None:
        np.savetxt(os.path.join(write, f"{args.ranks_name}.txt"), ranks)
    return metrics


if __name__ == "__main__":
    main()
