"""PREPRec CLI (counterpart of `bsarec_tpu/preprec/main.py`).

    python -m bsarec_tpu_torch.preprec.main --dataset douban/douban_music \
        --model newrec --data_dir ./data
    python -m bsarec_tpu_torch.preprec.main --dataset <target> --model newrec \
        --transfer --state_dict_path res/<src>/train/best.ckpt

`parse` takes the JAX CLI's flags, flag for flag; `--device` defaults to
cuda and raises without a card (`--device cpu` runs on the CPU). `--model`
is one of newrec, newb4rec, sasrec, bert4rec, bprmf, cl4srec (trained by
`PrepRecTrainer.fit`, or evaluated on `--mode` with `--inference_only`)
or mostpop (the popularity baseline, no model). BERT4Rec and NewB4Rec
train only with a nonzero `--mask_prob`: at the default 0 their loss is 0.
Checkpoints go to `res/<dataset>/<train_dir>/` as torch state_dicts, and
so do the other outputs, under the JAX CLI's names:

- `--state_dict_path` loads a checkpoint partially before anything else
  (`PrepRecTrainer.load_transfer`; with `--fs_emb` only the few-shot
  adapter trains); with `--transfer` it also sets `--inference_only`;
  `--fs_transfer` trains for `--fs_num_epochs` epochs, each `--fs_prop`
  of the batches;
- `--dataset2` trains NewRec on a second dataset through the same
  parameters each epoch;
- `--save_scores` writes the raw score rows to
  `preds{_global}{_transf}.txt` (`_global` under `--eval_method 3`);
  `--use_scores` with `--inference_only` blends them, loaded from
  `--use_score_dir`, with fresh scores at each of `--alphas` and logs the
  metrics (`evaluate.ensemble_ranks`, ties counted optimistically);
- `--export_user_embed` writes NewRec's [U, H] user states to
  `user_embed_<label>.txt` and stops;
- `--export_serving <path>` writes the candidate scorer (`serving.py`).

`--prng` is accepted and changes nothing: PREPRec's dropout is nn.Dropout.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np

from bsarec_tpu_torch.config import resolve_device
from bsarec_tpu_torch.preprec.config import PrepRecConfig, PrepRecTrainConfig
from bsarec_tpu_torch.preprec.data import load_intwtime, load_userneg
from bsarec_tpu_torch.preprec.evaluate import (
    build_eval_inputs,
    ensemble_ranks,
    metrics_from_ranks,
    mostpop_ranks,
)
from bsarec_tpu_torch.preprec.popularity import EvalPopularity, PopularityEncoding
from bsarec_tpu_torch.preprec.train import PrepRecTrainer


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
    p.add_argument("--state_dict_path", default=None, type=str)
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
    p.add_argument("--transfer", action="store_true")
    p.add_argument("--fs_transfer", action="store_true")
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
    p.add_argument("--dataset2", default="", type=str)
    p.add_argument("--save_scores", action="store_true")
    p.add_argument("--use_scores", action="store_true")
    p.add_argument("--use_score_dir", default="", type=str)
    p.add_argument("--alphas", nargs="+", default=[0.5], type=float)
    p.add_argument("--export_user_embed", "--save_emb", dest="export_user_embed",
                   action="store_true")
    p.add_argument("--label", default="embed", type=str)
    p.add_argument("--export_serving", default=None, type=str)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
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
    if args.transfer and args.state_dict_path:
        args.inference_only = True  # zero-shot transfer: load the weights, train nothing
    if args.fs_transfer:
        args.num_epochs = args.fs_num_epochs

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

    if args.model == "mostpop":
        rawpop = np.loadtxt(f"{prefix}_{args.rawpop}.txt").reshape(-1)
        inputs = build_eval_inputs(ds, cfg, args.mode, usernegs)
        t0 = time.perf_counter()
        ranks = mostpop_ranks(inputs, rawpop, np.random.default_rng(args.seed),
                              exclude_rated=args.eval_method == 3)
        seconds = time.perf_counter() - t0
        logger.info(f"mostpop {args.mode}: {ranks.size} users in {seconds:.3f}s "
                    f"({ranks.size / seconds:.1f} users/s)")
        metrics = metrics_from_ranks(ranks, cfg.topk)
        for (ndcg, hr), k in zip(metrics, cfg.topk):
            logger.info(f"{args.mode} NDCG@{k}: {ndcg}, HR@{k}: {hr}")
        return metrics

    pop_enc = eval_pop = None
    if args.model in ("newrec", "newb4rec"):
        pop_enc = PopularityEncoding.load(
            f"{prefix}_{args.monthpop}.txt", f"{prefix}_{args.weekpop}.txt", cfg, device)
        if args.use_week_eval:
            eval_pop = EvalPopularity.load(f"{prefix}_{args.monthpop}.txt",
                                           f"{prefix}_{args.week_eval_pop}.txt", cfg, device)

    user_feat = None
    if args.triplet_loss or args.cos_loss:
        user_feat = np.loadtxt(f"{prefix}_{args.reg_file}.txt")

    write = os.path.join("res", args.dataset, args.train_dir)
    trainer = PrepRecTrainer(cfg, tcfg, ds, logger, write, pop_enc, eval_pop, usernegs, user_feat)
    if args.state_dict_path:
        trainer.load_transfer(args.state_dict_path)
        logger.info(f"loaded transfer weights from {args.state_dict_path}")

    second = None
    if args.dataset2:
        prefix2 = os.path.join(args.data_dir, args.dataset2)
        ds2 = load_intwtime(f"{prefix2}_{stem}.csv", args.maxlen, sparse=args.sparse)
        cfg2 = cfg.replace(usernum=ds2.usernum, itemnum=ds2.itemnum)
        pop2 = PopularityEncoding.load(
            f"{prefix2}_{args.monthpop}.txt", f"{prefix2}_{args.weekpop}.txt", cfg2, device)
        negs2 = None
        if args.eval_method == 1:
            negs2 = load_userneg(f"{prefix2}_{args.userneg}.pickle", ds2.usernum)
        second = PrepRecTrainer(cfg2, tcfg, ds2, logger,
                                os.path.join("res", args.dataset2, args.train_dir),
                                pop2, None, negs2, None)

    if args.export_user_embed:
        emb = trainer.user_embeddings(args.mode)
        np.savetxt(os.path.join(write, f"user_embed_{args.label}.txt"), emb)
        logger.info(f"exported user embeddings {emb.shape} to {write}")
        return None

    ranks = None
    if args.inference_only:
        if args.use_scores:
            scores = trainer.eval_scores(args.mode)
            per_alpha = ensemble_ranks(scores, np.loadtxt(args.use_score_dir), args.alphas)
            metrics = None
            for alpha, alpha_ranks in zip(args.alphas, per_alpha):
                metrics = metrics_from_ranks(alpha_ranks, cfg.topk)
                logger.info(f"alpha={alpha}: {metrics}")
        else:
            metrics, ranks = trainer.evaluate(args.mode, userpop)
            for (ndcg, hr), k in zip(metrics, cfg.topk):
                logger.info(f"{args.mode} NDCG@{k}: {ndcg}, HR@{k}: {hr}")
    else:
        metrics, ranks = trainer.fit(userpop=userpop, second=second)

    if args.save_scores:
        add = ("_global" if args.eval_method == 3 else "") + ("_transf" if args.transfer else "")
        np.savetxt(os.path.join(write, f"preds{add}.txt"), trainer.eval_scores(args.mode))
    if args.save_ranks and not args.use_scores and ranks is not None:
        np.savetxt(os.path.join(write, f"{args.ranks_name}.txt"), ranks)

    if args.export_serving:
        from bsarec_tpu_torch.preprec.serving import export_candidate_scorer

        n_cands = build_eval_inputs(ds, cfg, args.mode, usernegs).num_cands
        meta = export_candidate_scorer(trainer.model, cfg, pop_enc, eval_pop, args.maxlen,
                                       n_cands, args.export_serving)
        logger.info(f"exported candidate scorer: {meta}")
    return metrics


if __name__ == "__main__":
    main()
