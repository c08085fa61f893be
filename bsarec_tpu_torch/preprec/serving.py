"""The PREPRec candidate scorer as a serving artifact (counterpart of
`bsarec_tpu/preprec/serving.py`).

PREPRec's eval scores a user's candidate set from popularity-encoded
inputs: items are represented by their popularity trajectories, tables
built offline by the weekly preprocessing (`preprocess.py`). The export
therefore bakes both the trained parameters and the popularity tables
into one self-contained `torch.export` `.pt2` per (checkpoint, popularity
snapshot); re-export after each refresh of the tables.

The artifact's call is batch-polymorphic over users:

    (seqs [b, L], t1 [b, L], t2 [b, L], cands [b, C], ct1 [b, C],
     ct2 [b, C], users [b]; int32) -> scores [b, C] float32

It is the eval's candidate scoring (`evaluate.final_state` against
`evaluate.cand_embed`, which is each model's `predict`) without the
rank's randomness: ranking a candidate set is a stable argsort on the
client (`PrepRecScorer.topk`), the eval's random tie-break is a metric
protocol, not a serving behaviour. `use_week_eval` artifacts take
NewRec's candidate features from the week-adjusted eval table. A
time-embedded model is refused: its te input is derivable only from the
training-time dataset layout.

The artifact's metadata (model, seq_len, n_cands, the call, the export's
device) travels inside it. `load_candidate_scorer` loads it on the card
unless the caller asks for the CPU, moving it across devices where it was
exported on the other one.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch
from torch import nn

from bsarec_tpu_torch.preprec.config import PrepRecConfig
from bsarec_tpu_torch.preprec.evaluate import cand_embed, final_state
from bsarec_tpu_torch.preprec.popularity import (
    EvalPopularity,
    PopularityEncoding,
    PopularityTable,
)

PREPREC_CALL_DOC = (
    "(seqs [b, L] i32, t1 [b, L] i32, t2 [b, L] i32, cands [b, C] i32, "
    "ct1 [b, C] i32, ct2 [b, C] i32, users [b] i32) -> scores [b, C] f32"
)
_META_FILE = "preprec_scorer_meta.json"


class CandidateScorer(nn.Module):
    """The candidate scoring over `model`'s weights, the popularity tables
    held as buffers so that an export bakes them in."""

    def __init__(self, model: nn.Module, cfg: PrepRecConfig, pop_enc: PopularityEncoding | None,
                 eval_pop: EvalPopularity | None):
        super().__init__()
        if cfg.time_embed:
            raise NotImplementedError(
                "--export_serving with --time_embed: the te input is derivable only from the "
                "training-time dataset layout; serve time-embedded models in-process through "
                "evaluate.make_eval_fn")
        self.model, self.cfg = model, cfg
        self._shapes = {}
        if pop_enc is not None:
            self._table("month", pop_enc.month)
            self._table("week", pop_enc.week)
        self.week_eval = cfg.use_week_eval and eval_pop is not None
        if self.week_eval:
            self._table("eval_month", eval_pop.month)
            self.register_buffer("week_eval_table", eval_pop.week_eval)
            self.base_dim2 = eval_pop.base_dim2

    def _table(self, name: str, table: PopularityTable):
        self.register_buffer(f"{name}_table", table.table)
        self._shapes[name] = (table.base_dim, table.nwin)

    def _pop(self, name: str) -> PopularityTable:
        return PopularityTable(getattr(self, f"{name}_table"), *self._shapes[name])

    def forward(self, seqs, t1, t2, cands, ct1, ct2, users):
        seqs, t1, t2, cands, ct1, ct2, users = (
            a.long() for a in (seqs, t1, t2, cands, ct1, ct2, users))
        pop = eval_pop = None
        if "month" in self._shapes:
            pop = PopularityEncoding(self._pop("month"), self._pop("week"))
        if self.week_eval:
            eval_pop = EvalPopularity(self._pop("eval_month"), self.week_eval_table, self.base_dim2)
        state = final_state(self.model, self.cfg, pop, seqs, t1, t2, None, users)
        emb = cand_embed(self.model, self.cfg, pop, eval_pop, cands, ct1, ct2, users)
        return torch.einsum("bcf,bf->bc", emb, state)


def build_candidate_scorer(model: nn.Module, cfg: PrepRecConfig, pop_enc=None,
                           eval_pop=None) -> CandidateScorer:
    """The eval's candidate scoring as a module of (seqs, t1, t2, cands,
    ct1, ct2, users) -> [b, C] scores (the module docstring's call)."""
    return CandidateScorer(model, cfg, pop_enc, eval_pop)


def export_candidate_scorer(model: nn.Module, cfg: PrepRecConfig, pop_enc, eval_pop,
                            seq_len: int, n_cands: int, path: str) -> dict:
    """Export the parameters- and tables-baked scorer, on the model's
    device, to `path` (`.pt2`, batch dimension dynamic); returns its
    metadata, which the artifact also holds, with the file's bytes and the
    export's seconds."""
    from torch.export import Dim

    t0 = time.perf_counter()
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    try:
        module = build_candidate_scorer(model, cfg, pop_enc, eval_pop).eval()
        b = Dim("b", min=1)

        def ints(*shape):
            return torch.ones(shape, dtype=torch.int32, device=device)

        example = (ints(2, seq_len), ints(2, seq_len), ints(2, seq_len), ints(2, n_cands),
                   ints(2, n_cands), ints(2, n_cands), ints(2))
        with torch.no_grad():
            program = torch.export.export(module, example, dynamic_shapes=tuple({0: b} for _ in example))
    finally:
        model.train(was_training)
    meta = {"path": path, "call": PREPREC_CALL_DOC, "device": device.type, "model": cfg.model,
            "seq_len": seq_len, "n_cands": n_cands, "use_week_eval": bool(module.week_eval)}
    torch.export.save(program, path, extra_files={_META_FILE: json.dumps(meta)})
    meta["bytes"] = os.path.getsize(path)
    meta["seconds"] = round(time.perf_counter() - t0, 3)
    return meta


class PrepRecScorer:
    """A loaded PREPRec serving artifact. `scores(...)` returns [b, C]
    candidate scores; `topk(..., k)` the top-k candidate COLUMNS (places
    in the submitted candidate list), a stable argsort of -scores."""

    def __init__(self, program, meta: dict, device: torch.device):
        self._module = program.module()
        self.meta = meta
        self.device = device

    @property
    def seq_len(self) -> int:
        return self.meta["seq_len"]

    @property
    def n_cands(self) -> int:
        return self.meta["n_cands"]

    def scores(self, seqs, t1, t2, cands, ct1, ct2, users=None) -> np.ndarray:
        seqs = np.asarray(seqs)
        if users is None:
            users = np.zeros((seqs.shape[0],), np.int32)
        args = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(self.device)
                for a in (seqs, t1, t2, cands, ct1, ct2, users)]
        with torch.inference_mode():
            return self._module(*args).cpu().numpy()

    def topk(self, seqs, t1, t2, cands, ct1, ct2, users=None, k: int = 10) -> np.ndarray:
        s = self.scores(seqs, t1, t2, cands, ct1, ct2, users)
        return np.argsort(-s, axis=1, kind="stable")[:, :k]


def load_candidate_scorer(path: str, device: str | torch.device = "cuda") -> PrepRecScorer:
    """Load an artifact written by `export_candidate_scorer` onto `device`
    (the card unless the caller asks for the CPU; without a card, cuda
    raises). Needs no model code, checkpoint or popularity file."""
    from bsarec_tpu_torch.config import resolve_device

    device = resolve_device(device)
    extra = {_META_FILE: ""}
    program = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[_META_FILE])
    if meta["device"] != device.type:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, device)
    return PrepRecScorer(program, meta, device)
