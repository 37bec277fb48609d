"""Batching for CALM training (counterpart of audio_calm_tpu/data/
collator.py, its TTS stream): static-shape collation, the first-fit-
decreasing pack plan of TTS texts into LLM rows, and the task-homogeneous
batch iterator. Batches are numpy arrays, equal to the JAX package's for
the same store and seed.

Not ported yet, and raising NotImplementedError where reached: the ASR
stream (`spec_augment`, `pack_asr_window`, `materialize_asr_rows`, and in
the iterator a dataset with ASR items, whose batches `asr_text_pad` and
ASR packing shape; ROADMAP Queue 1 item 4) and multi-host iteration
(`process_count > 1`; Queue 1 item 8).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from audio_calm_torch.data.datasets import CalmDataset, CalmExample

_ASR = "ROADMAP Queue 1 item 4, ASR training and the mix"


def _asr_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({_ASR})")


def spec_augment(audio, rng, min_len: int = 5, max_len: int = 10):
    """SpecAugment of ASR training batches."""
    raise _asr_not_ported("spec_augment")


def materialize_asr_rows(*args, **kwargs):
    """The packed-ASR rows."""
    raise _asr_not_ported("materialize_asr_rows")


def pack_asr_window(*args, **kwargs):
    """The packed-ASR window."""
    raise _asr_not_ported("pack_asr_window")


def collate_calm(examples: List[CalmExample], pad_token_id: int,
                 max_text_len: int, max_audio_len: int, latent_dim: int,
                 training: bool = False,
                 rng: Optional[np.random.Generator] = None,
                 text_pad: Optional[int] = None) -> Dict[str, np.ndarray]:
    """-> a static-shape batch (channels-last audio [B, T, D]): text ids
    and mask padded to `text_pad` or max_text_len, labels to max_text_len,
    audio to max_audio_len."""
    B = len(examples)
    t_txt = text_pad if text_pad is not None else max_text_len
    text_ids = np.full((B, t_txt), pad_token_id, np.int32)
    attention_mask = np.zeros((B, t_txt), np.int32)
    labels = np.full((B, max_text_len), -100, np.int32)
    audio = np.zeros((B, max_audio_len, latent_dim), np.float32)
    audio_mask = np.zeros((B, max_audio_len), np.int32)
    for i, ex in enumerate(examples):
        ids = ex.input_ids[:t_txt]
        text_ids[i, : len(ids)] = ids
        attention_mask[i, : len(ids)] = 1
        lab = ex.labels[:max_text_len]
        labels[i, : len(lab)] = lab
        a = ex.audio[:max_audio_len]
        if training and ex.mode == "asr" and rng is not None:
            a = spec_augment(a, rng)
        audio[i, : len(a)] = a
        audio_mask[i, : len(a)] = 1
    return {"text_ids": text_ids, "attention_mask": attention_mask,
            "labels": labels, "latents": audio, "audio_mask": audio_mask}


def plan_pack(costs: List[int], rows: int, row_len: int, segments: int
              ) -> Tuple[List[List[int]], List[int]]:
    """First-fit-decreasing pack of per-item token costs into `rows` rows of
    `row_len` capacity, at most `segments` items a row -> (per row the item
    positions in packing order, leftover positions). Deterministic in the
    input order (a stable sort)."""
    order = sorted(range(len(costs)), key=lambda i: -costs[i])
    caps = [row_len] * rows
    counts = [0] * rows
    assign: List[List[int]] = [[] for _ in range(rows)]
    leftover: List[int] = []
    for i in order:
        for r in range(rows):
            if counts[r] < segments and caps[r] >= costs[i]:
                assign[r].append(i)
                caps[r] -= costs[i]
                counts[r] += 1
                break
        else:
            leftover.append(i)
    return assign, leftover


def materialize_tts_rows(row_items: List[List[Optional[CalmExample]]],
                         row_len: int, segments: int, t_aud: int,
                         latent_dim: int, max_text_len: int
                         ) -> Dict[str, np.ndarray]:
    """The packed-TTS arrays of `row_items` (None = a failed load, a dummy
    slot). Each segment is [text (its exact length) | SOA]; indices are
    row-local, so any row subset (a microbatch slice) stands alone; the
    gathers of empty slots point at the zero column `row_len`."""
    rows = len(row_items)
    latents = np.zeros((rows, segments, t_aud, latent_dim), np.float32)
    audio_mask = np.zeros((rows, segments, t_aud), np.int32)
    text_mask = np.zeros((rows, segments, max_text_len), np.int32)
    tok_ids = np.zeros((rows, row_len), np.int32)
    kind = np.zeros((rows, row_len), np.int32)
    segment_ids = np.zeros((rows, row_len), np.int32)
    position_ids = np.zeros((rows, row_len), np.int32)
    ctx_idx = np.full((rows, segments, max_text_len), row_len, np.int32)
    soa_idx = np.full((rows, segments), row_len, np.int32)
    for r, items in enumerate(row_items):
        t = 0
        for s, ex in enumerate(items):
            if ex is None:
                continue
            ids = ex.input_ids[:max_text_len]
            n = len(ids)
            a = ex.audio[:t_aud]
            latents[r, s, : len(a)] = a
            audio_mask[r, s, : len(a)] = 1
            text_mask[r, s, :n] = 1
            tok_ids[r, t: t + n] = ids
            kind[r, t: t + n] = 1
            kind[r, t + n] = 2
            ctx_idx[r, s, :n] = t + np.arange(n)
            soa_idx[r, s] = t + n
            segment_ids[r, t: t + n + 1] = s + 1
            position_ids[r, t: t + n + 1] = np.arange(n + 1)
            t += n + 1
    return {"latents": latents, "audio_mask": audio_mask,
            "text_mask": text_mask, "tok_ids": tok_ids, "kind": kind,
            "segment_ids": segment_ids, "position_ids": position_ids,
            "ctx_idx": ctx_idx, "soa_idx": soa_idx}


def pack_tts_window(examples: List[CalmExample], rows: int, row_len: int,
                    segments: int, t_aud: int, latent_dim: int,
                    max_text_len: int
                    ) -> Tuple[Dict[str, np.ndarray], List[int]]:
    """FFD-pack TTS texts into `rows` LLM rows -> (the batch of
    QwenCALM.forward_tts_packed, leftover example indices). The audio side
    stays per slot on the `t_aud` grid; empty slots are dummies."""
    if row_len < max_text_len + 1:
        raise ValueError(f"tts_pack_len={row_len} cannot fit a max-length "
                         f"segment ({max_text_len} tokens + SOA)")
    costs = [min(len(e.input_ids), max_text_len) + 1 for e in examples]
    assign, leftover = plan_pack(costs, rows, row_len, segments)
    batch = materialize_tts_rows(
        [[examples[i] for i in idxs] for idxs in assign],
        row_len, segments, t_aud, latent_dim, max_text_len)
    return batch, leftover


def estimate_packed_steps_per_epoch(dataset: CalmDataset, task: str,
                                    rows: int, row_len: int, segments: int,
                                    sample: int = 128, fill: float = 0.9,
                                    seed: int = 0) -> int:
    """Optimizer steps one epoch of the packed iterator takes, from the
    mean cost of `sample` items (tokens for TTS, latent frames + prompt for
    ASR) and a fill factor for FFD fragmentation. It sizes the LR schedule;
    the stop is exact regardless (the iterator ends after its epochs)."""
    items = dataset.tts_items if task == "tts" else dataset.asr_items
    n = len(items)
    if n == 0:
        return 0
    rng = np.random.default_rng(seed)
    costs = []
    for i in rng.permutation(n)[:sample]:
        ex = dataset.get(task, int(i))
        if ex is None:
            continue
        if task == "tts":
            costs.append(min(len(ex.input_ids), dataset.max_text_len) + 1)
        else:
            costs.append(min(len(ex.audio), dataset.max_audio_len) + 1
                         + len(dataset.asr_prompt_ids))
    if not costs:
        return max(n // max(rows * segments, 1), 1)
    per_row = max(row_len * fill / float(np.mean(costs)), 1.0)
    utts = max(min(rows * segments, int(rows * per_row)), 1)
    return max(int(np.ceil(n / utts)), 1)


def calm_batch_iterator(
    dataset: CalmDataset,
    batch_size: int,
    pad_token_id: int,
    latent_dim: int,
    task_prob_tts: float = 0.5,
    training: bool = True,
    seed: int = 0,
    epochs: Optional[int] = None,
    audio_buckets: Optional[List[int]] = None,
    length_group_window: int = 0,
    asr_text_pad: Optional[int] = None,
    asr_pack_rows: int = 0,
    asr_pack_len: int = 512,
    asr_pack_segments: int = 4,
    tts_pack_rows: int = 0,
    tts_pack_len: int = 256,
    tts_pack_segments: int = 8,
    process_index: int = 0,
    process_count: int = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield static TTS batches (`task` "tts" or "tts_packed"), dropping
    ragged tails; the JAX iterator's order for the same seed.

    Each epoch draws a permutation of the items; a sample that does not
    load is skipped and backfilled. audio_buckets (ascending): a batch pads
    its audio to the smallest bucket that fits its longest example.
    length_group_window = N > 0: examples are drawn N batches at a time,
    sorted by audio length, sliced into batches and the batches shuffled
    (their own generator, so the order stream does not move).
    tts_pack_rows > 0: pools of rows x segments utterances (x N with
    grouping, sorted and sliced into groups alike) FFD-pack into the LLM
    rows; what does not fit is carried into the next group, and the epoch's
    tail pools are emitted underfull. A packed batch carries `n_samples`,
    its utterance count. task_prob_tts and the asr_* arguments are the ASR
    stream's, which is not ported: a dataset with ASR items raises."""
    if process_count > 1:
        raise NotImplementedError(
            "multi-host iteration (process_count > 1) is not ported yet "
            "(ROADMAP Queue 1 item 8)")
    if dataset.asr_items:
        raise _asr_not_ported("the ASR stream of calm_batch_iterator "
                              "(ASR batches, asr_text_pad, ASR packing)")
    if asr_pack_rows > 0:
        p = len(dataset.asr_prompt_ids)
        if asr_pack_len < dataset.max_audio_len + 1 + p:
            raise ValueError(
                f"asr_pack_len={asr_pack_len} cannot fit a max-length "
                f"segment ({dataset.max_audio_len} frames + SOA + {p}-token "
                "prompt)")
    if tts_pack_rows > 0 and tts_pack_len < dataset.max_text_len + 1:
        raise ValueError(
            f"tts_pack_len={tts_pack_len} cannot fit a max-length segment "
            f"({dataset.max_text_len} tokens + SOA)")
    if audio_buckets:
        audio_buckets = sorted(audio_buckets)
    rng = np.random.default_rng(seed)
    # the window shuffles draw from their own stream, so that grouping
    # does not shift the order stream
    group_rng = np.random.default_rng((seed, 0x67726F75))
    n_items = len(dataset.tts_items)
    epoch = 0
    while epochs is None or epoch < epochs:
        if not n_items:
            return
        order = list(rng.permutation(n_items))
        cursor = 0
        pending: List[List[CalmExample]] = []  # length-grouped batches
        carry: List[CalmExample] = []  # a window's < batch_size leftover
        pack_carry: list = []  # packed leftovers
        pack_pending: list = []  # packed groups
        yielded = False

        def draw():
            nonlocal cursor
            ex = dataset.get("tts", order[cursor])
            cursor += 1
            return ex

        while True:
            if tts_pack_rows > 0:
                if not (pack_pending or pack_carry
                        or cursor + tts_pack_rows <= n_items):
                    break
                if not pack_pending:
                    gsize = tts_pack_rows * tts_pack_segments
                    want = gsize * max(length_group_window, 1)
                    pool, pack_carry = pack_carry, []
                    while len(pool) < want and cursor < n_items:
                        ex = draw()
                        if ex is not None:
                            pool.append((ex, min(len(ex.input_ids),
                                                 dataset.max_text_len),
                                         min(len(ex.audio),
                                             dataset.max_audio_len)))
                    if not pool:
                        continue
                    if length_group_window > 0:
                        pool.sort(key=lambda e: e[2])  # stable, audio length
                    groups = [pool[i: i + gsize]
                              for i in range(0, len(pool), gsize)]
                    if length_group_window > 0:
                        group_rng.shuffle(groups)
                    pack_pending.extend(groups)
                group = pack_pending.pop(0)
                t_aud = dataset.max_audio_len
                if audio_buckets:
                    longest = max(e[2] for e in group)
                    t_aud = next((b for b in audio_buckets if b >= longest),
                                 dataset.max_audio_len)
                assign, left = plan_pack([e[1] + 1 for e in group],
                                         tts_pack_rows, tts_pack_len,
                                         tts_pack_segments)
                row_items = [[group[i][0] for i in idxs] for idxs in assign]
                batch = materialize_tts_rows(
                    row_items, tts_pack_len, tts_pack_segments, t_aud,
                    latent_dim, dataset.max_text_len)
                pack_carry.extend(group[i] for i in left)
                batch["task"] = "tts_packed"
                batch["n_samples"] = sum(len(row) for row in row_items)
                yielded = True
                yield batch
                continue
            if not (pending or cursor + batch_size <= n_items):
                break
            if length_group_window > 0:
                if not pending:
                    want = batch_size * length_group_window
                    window, carry = carry, []
                    while len(window) < want and cursor < n_items:
                        ex = draw()
                        if ex is not None:
                            window.append(ex)
                    window.sort(key=lambda e: len(e.audio))  # stable
                    n_full = len(window) - len(window) % batch_size
                    groups = [window[i: i + batch_size]
                              for i in range(0, n_full, batch_size)]
                    carry = window[n_full:]
                    group_rng.shuffle(groups)
                    pending.extend(groups)
                if not pending:
                    break
                examples = pending.pop(0)
            else:
                examples = []
                while len(examples) < batch_size and cursor < n_items:
                    ex = draw()
                    if ex is not None:
                        examples.append(ex)
                if len(examples) < batch_size:
                    break
            t_aud = dataset.max_audio_len
            if audio_buckets:
                longest = max(len(ex.audio) for ex in examples)
                t_aud = next((b for b in audio_buckets if b >= longest),
                             dataset.max_audio_len)
            batch = collate_calm(examples, pad_token_id, dataset.max_text_len,
                                 t_aud, latent_dim, training=training)
            batch["task"] = "tts"  # host-side routing key
            yielded = True
            yield batch
        if training and not yielded:
            # a zero-batch epoch would repeat forever with epochs=None
            raise ValueError(
                f"no full batch can be formed: dataset has {n_items} tts "
                f"items but batch_size={batch_size}; reduce the batch size "
                "or add data")
        epoch += 1
        if not training:
            return
