"""The pretraining task datasets, MLM, MFM, FOM and VSM, as fixed-shape
numpy structs (a copy of ``hero_tpu/data/pretrain_tasks.py``: for the same
(seed, epoch, index) the same arrays).

Every item draws from its own ``random.Random`` seeded by (seed, epoch,
index), so any process reproduces any item without a broadcast.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Sequence

import numpy as np

from hero_tpu_torch.data.video import (VideoFeatSubTokDataset, pad_query,
                                       stack_items)


def mlm_row_cap(mask_prob: float, txt_len: int) -> int:
    """Static per-row cap on MLM mask slots (``FixedShapes.max_masked``):
    the configured mask rate plus a binomial tail margin of max(0.1, 6
    sigma at the row's maskable tokens) plus the one forced mask of
    :func:`random_word` (42 at mask_prob 0.15 and a 122-token packed
    row).  A label past the cap is counted (``mlm_labels_dropped``)."""
    n = max(txt_len - 1, 1)   # maskable tokens: the row minus its lead CLS
    margin = max(0.1, 6.0 * math.sqrt(mask_prob * (1.0 - mask_prob) / n))
    cap = int(min(1.0, mask_prob + margin) * n) + 1
    return min(n, max(cap, 1))


def random_word(tokens: List[int], vocab_range, mask_tok: int,
                rng: random.Random, mask_prob: float = 0.15):
    """BERT 80/10/10 masking; at least one token is masked."""
    labels = []
    tokens = list(tokens)
    for i, tok in enumerate(tokens):
        prob = rng.random()
        if prob < mask_prob:
            prob /= mask_prob
            if prob < 0.8:
                tokens[i] = mask_tok
            elif prob < 0.9:
                tokens[i] = rng.randrange(vocab_range[0], vocab_range[1])
            labels.append(tok)
        else:
            labels.append(-1)
    if all(lab == -1 for lab in labels):
        labels[0] = tokens[0]
        tokens[0] = mask_tok
    return tokens, labels


def random_reorder(pos_ids: Sequence[int], rng: random.Random,
                   p: float = 0.15):
    """FOM: a share ``p`` of the positions shuffled among themselves.
    Returns (the slot each position goes to, the original position of each
    slot or -1)."""
    selected, target = [], []
    for i, pos in enumerate(pos_ids):
        if rng.random() < p:
            selected.append(i)
            target.append(pos)
    shuffled = list(target)
    rng.shuffle(shuffled)
    order = list(pos_ids)
    out_target = [-1] * len(order)
    for i, pos in enumerate(selected):
        order[pos] = shuffled[i]
        out_target[shuffled[i]] = pos
    return order, out_target


class _TaskDataset:
    def __init__(self, video_ids: Sequence[str],
                 video_db: VideoFeatSubTokDataset, seed: int = 0):
        self.video_db = video_db
        self.ids = list(video_ids)
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _rng(self, i: int) -> random.Random:
        return random.Random((self.seed * 1_000_003 + self.epoch)
                             * 1_000_003 + i)

    def __len__(self):
        return len(self.ids)


class MlmDataset(_TaskDataset):
    """Masked subtitle modelling: each sub's own tokens BERT-masked behind
    a leading ``[CLS]``; (S, M) mask positions (row-relative) and labels
    (-1 = pad slot)."""

    def __init__(self, video_ids, video_db, mask_prob: float = 0.15,
                 seed: int = 0):
        super().__init__(video_ids, video_db, seed)
        self.mask_prob = mask_prob

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        rng = self._rng(i)
        vid = self.ids[i]
        db = self.video_db
        sp = db.shapes
        item = db.video_item(vid)
        example = db.txt_db[vid]
        sub2frames = db.sub2frames(vid)
        num_subs = len(sub2frames)
        mask_pos = np.zeros((sp.n_subs, sp.max_masked), np.int32)
        labels = np.full((sp.n_subs, sp.max_masked), -1, np.int32)
        slots = [0] * sp.n_subs                 # per-row fill cursor
        # pack mode: a sub's rewrite lands at its placement; the rng
        # stream is read for every sub, dropped ones too, so the masks do
        # not shift with the bucket
        pack_map = item.get("__pack_map")
        sub_iter = (sub2frames if db.pack else sub2frames[:sp.n_subs])
        for row, (sub_idx, _) in enumerate(sub_iter):
            ids = db.sub_tokens(example, sub_idx, num_subs)
            masked, labs = random_word(ids[1:], db.txt_db.v_range,
                                       db.txt_db.mask, rng,
                                       self.mask_prob)
            if db.pack:
                pl = pack_map.get(sub_idx)
                if pl is None:
                    continue             # dropped by the packer (counted)
                row, off = pl.row, pl.toff
            else:
                off = 0
            new_ids = [db.txt_db.cls_] + masked
            item["sub_input_ids"][row, off:off + len(new_ids)] = new_ids
            for pos, lab in enumerate(labs, start=1):
                if lab == -1:
                    continue
                if slots[row] < sp.max_masked:
                    mask_pos[row, slots[row]] = off + pos
                    labels[row, slots[row]] = lab
                    slots[row] += 1
                else:
                    db.trunc_counts["mlm_labels_dropped"] = (
                        db.trunc_counts.get("mlm_labels_dropped", 0) + 1)
        item["mlm_mask_pos"] = mask_pos
        item["mlm_labels"] = labels
        return item


class MfmDataset(_TaskDataset):
    """Masked frame modelling: a clip-level frame mask ``c_v_masks`` with
    at least one masked frame."""

    def __init__(self, video_ids, video_db, mask_prob: float = 0.15,
                 seed: int = 0):
        super().__init__(video_ids, video_db, seed)
        self.mask_prob = mask_prob

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        rng = self._rng(i)
        item = self.video_db.video_item(self.ids[i])
        nf = int(item["c_attn_masks"].sum())
        mask = np.zeros((self.video_db.shapes.n_frames,), np.float32)
        flags = [rng.random() < self.mask_prob for _ in range(nf)]
        if not any(flags):
            flags[rng.randrange(nf)] = True
        mask[:nf] = np.asarray(flags, np.float32)
        item["c_v_masks"] = mask
        return item


class FomDataset(_TaskDataset):
    """Frame order modelling: ``shuffled_orders`` (a permutation of the
    frames) and ``fom_targets`` (original position or -1)."""

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        rng = self._rng(i)
        item = self.video_db.video_item(self.ids[i])
        F = self.video_db.shapes.n_frames
        nf = int(item["c_attn_masks"].sum())
        order, target = random_reorder(list(range(nf)), rng)
        orders = np.arange(F, dtype=np.int32)
        targets = np.full((F,), -1, np.int32)
        orders[:nf] = order
        targets[:nf] = target
        item["shuffled_orders"] = orders
        item["fom_targets"] = targets
        return item


class VsmDataset(_TaskDataset):
    """Video-subtitle matching: up to Q subs sampled as queries (their text
    left out of the video's rows), targets their frame spans; a video
    with fewer matched subs repeats its last query up to Q."""

    def __init__(self, video_ids, video_db, query_per_video: int = 5,
                 seed: int = 0):
        super().__init__(video_ids, video_db, seed)
        self.query_per_video = query_per_video

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        rng = self._rng(i)
        vid = self.ids[i]
        db = self.video_db
        sp = db.shapes
        Q = self.query_per_video
        example = db.txt_db[vid]
        sub2frames = db.sub2frames(vid)
        nframes = db.nframes(vid)

        matched = [s for s, f in sub2frames if f]
        n_samples = min(len(matched), Q)
        query_subs = set(rng.sample(matched, n_samples))
        item = db.video_item(vid, exclude_subs=query_subs)

        q_ids = np.full((Q, sp.query_len), db.txt_db.pad, np.int32)
        q_mask = np.zeros((Q, sp.query_len), np.float32)
        qv_mask = np.zeros((Q,), np.float32)
        targets = np.full((Q, 2), -1, np.int32)
        rows = []
        for sub_idx, frames in sub2frames:
            if sub_idx in query_subs and frames:
                toks = example["input_ids"][sub_idx]
                if db.max_txt_len != -1:
                    toks = toks[:db.max_txt_len]
                st = frames[0]
                ed = min(max(frames[0] + 1, frames[-1]), nframes - 1)
                rows.append(([db.txt_db.cls_] + list(toks), (st, ed)))
        while rows and len(rows) < Q:
            rows.append(rows[-1])
        for qi, (toks, (st, ed)) in enumerate(rows[:Q]):
            ids, m = pad_query(toks, sp.query_len, db.txt_db.pad)
            q_ids[qi] = ids
            q_mask[qi] = m
            qv_mask[qi] = 1.0
            targets[qi] = (st, ed)
        item["query_input_ids"] = q_ids
        item["query_attn_masks"] = q_mask
        item["q_mask"] = qv_mask
        item["targets"] = targets
        return item


def build_batch(dataset, indices: Sequence[int]) -> Dict[str, np.ndarray]:
    return stack_items([dataset[i] for i in indices])
