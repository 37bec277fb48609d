"""Batching for CALM training (counterpart of audio_calm_tpu/data/
collator.py): static-shape collation with SpecAugment on ASR batches, the
first-fit-decreasing pack plan of TTS texts and of ASR [audio | SOA |
prompt] segments into LLM rows, and the task-homogeneous batch iterator
(the Bernoulli task draw of the mix, buckets, length grouping, packing),
and `mel_batch_iterator`, the VAE's mel-crop batches. Batches are numpy
arrays, equal to the JAX package's for the same store and seed.

Multi-process (`process_count > 1`, one process per device of a
data-parallel run): `batch_size` is the global batch and every process
draws the same order and task stream but loads only its batch_size /
process_count rows, as the JAX package's iterator does.
"""

from __future__ import annotations

import warnings
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from audio_calm_torch.data.datasets import (CalmDataset, CalmExample,
                                            MelDataset)


def spec_augment(audio: np.ndarray, rng: np.random.Generator,
                 min_len: int = 5, max_len: int = 10) -> np.ndarray:
    """Zero one random time span of min_len..max_len frames (T > 20
    only); a copy, the input stays as it is."""
    T = audio.shape[0]
    if T <= 20:
        return audio
    mask_len = int(rng.integers(min_len, max_len + 1))
    t0 = int(rng.integers(0, T - mask_len + 1))
    audio = audio.copy()
    audio[t0: t0 + mask_len] = 0.0
    return audio


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


def materialize_asr_rows(row_items: List[List[Optional[CalmExample]]],
                         prompt_ids: np.ndarray, row_len: int, segments: int,
                         seg_frames: int, latent_dim: int, max_text_len: int,
                         training: bool = False,
                         rng: Optional[np.random.Generator] = None
                         ) -> Dict[str, np.ndarray]:
    """The packed-ASR arrays of `row_items` (None = a failed load, a dummy
    slot). Each segment is [audio (its exact length) | SOA | prompt]; in
    training the audio is SpecAugmented per slot from `rng`. Indices are
    row-local, so any row subset (a microbatch slice) stands alone; the
    gathers of empty positions point at the zero column (`segments *
    seg_frames` for the embeddings, `row_len` for the hidden states)."""
    rows = len(row_items)
    P = len(prompt_ids)
    latents = np.zeros((rows, segments, seg_frames, latent_dim), np.float32)
    latent_mask = np.zeros((rows, segments, seg_frames), np.int32)
    labels = np.full((rows, segments, max_text_len), -100, np.int32)
    tok_ids = np.zeros((rows, row_len), np.int32)
    kind = np.zeros((rows, row_len), np.int32)
    gather_idx = np.full((rows, row_len), segments * seg_frames, np.int32)
    segment_ids = np.zeros((rows, row_len), np.int32)
    position_ids = np.zeros((rows, row_len), np.int32)
    ctx_idx = np.full((rows, segments, seg_frames), row_len, np.int32)
    for r, items in enumerate(row_items):
        t = 0
        for s, ex in enumerate(items):
            if ex is None:
                continue
            a = ex.audio[:seg_frames]
            if training and rng is not None:
                a = spec_augment(a, rng)
            n = len(a)
            latents[r, s, :n] = a
            latent_mask[r, s, :n] = 1
            lab = ex.labels[:max_text_len]
            labels[r, s, : len(lab)] = lab
            kind[r, t: t + n] = 1
            gather_idx[r, t: t + n] = s * seg_frames + np.arange(n)
            ctx_idx[r, s, :n] = t + np.arange(n)
            segment_ids[r, t: t + n + 1 + P] = s + 1
            position_ids[r, t: t + n + 1 + P] = np.arange(n + 1 + P)
            kind[r, t + n] = 2
            kind[r, t + n + 1: t + n + 1 + P] = 3
            tok_ids[r, t + n + 1: t + n + 1 + P] = prompt_ids
            t += n + 1 + P
    return {"latents": latents, "latent_mask": latent_mask, "labels": labels,
            "tok_ids": tok_ids, "kind": kind, "gather_idx": gather_idx,
            "segment_ids": segment_ids, "position_ids": position_ids,
            "ctx_idx": ctx_idx}


def pack_asr_window(examples: List[CalmExample], prompt_ids: np.ndarray,
                    rows: int, row_len: int, segments: int, seg_frames: int,
                    latent_dim: int, max_text_len: int,
                    training: bool = False,
                    rng: Optional[np.random.Generator] = None
                    ) -> Tuple[Dict[str, np.ndarray], List[int]]:
    """FFD-pack ASR examples into `rows` LLM rows -> (the batch of
    QwenCALM.forward_asr_packed, leftover example indices). Segments are
    [audio | SOA | prompt] with no padding between them."""
    P = len(prompt_ids)
    if row_len < seg_frames + 1 + P:
        raise ValueError(f"asr_pack_len={row_len} cannot fit a max-length "
                         f"segment ({seg_frames} frames + SOA + {P}-token "
                         "prompt)")
    costs = [min(len(e.audio), seg_frames) + 1 + P for e in examples]
    assign, leftover = plan_pack(costs, rows, row_len, segments)
    batch = materialize_asr_rows(
        [[examples[i] for i in idxs] for idxs in assign], prompt_ids,
        row_len, segments, seg_frames, latent_dim, max_text_len,
        training=training, rng=rng)
    return batch, leftover


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
    """Yield task-homogeneous static batches (`task` "tts", "asr",
    "tts_packed" or "asr_packed"), dropping ragged tails; the JAX
    iterator's batches and task sequence for the same seed.

    Each epoch draws a permutation per task (TTS first); each batch's task
    is drawn ~ Bernoulli(task_prob_tts) among the tasks that can still form
    one, from the same generator. A sample that does not load is skipped
    and backfilled. audio_buckets (ascending): a plain batch, and a packed
    TTS group, pads its audio to the smallest bucket that fits its longest
    example. length_group_window = N > 0: examples are drawn N batches at
    a time, sorted by audio length, sliced into batches and the batches
    shuffled (their own generator, so the order and task stream does not
    move). Plain ASR batches pad their prompt to asr_text_pad (clamped to
    [len(prompt), max_text_len]) and are SpecAugmented in training, from a
    third generator. Packing (`<task>_pack_rows` > 0): pools FFD-pack
    into the LLM rows (TTS pools of rows x segments utterances, x N with
    grouping, sorted and sliced into groups alike; ASR pools of rows x
    segments utterances, exact frames, SpecAugmented per slot); what does
    not fit is carried into the next pool, and the epoch's tail pools are
    emitted underfull. A packed batch carries `n_samples`, its utterance
    count.

    Multi-process (process_count > 1): `batch_size` is the global batch;
    each process yields its rows [process_index x per, ... + per), per =
    batch_size / process_count, of the batch the shared order stream
    forms. A sample that does not load becomes a zero stub (not
    backfilled), so the processes stay in lock-step, and plain batches
    ignore audio_buckets and length grouping (the choice would depend on
    rows another process holds). Packing stays on when the store reads
    its metadata from headers (CalmDataset.supports_meta: npz / npy, not
    .pt) and the rows divide by process_count: every process plans the
    pack from that metadata, identically, and loads only its rows (a
    failed load is a dummy slot in its own rows); otherwise it falls back
    to plain batches with a warning. SpecAugment draws from
    default_rng((seed, process_index))."""
    if process_count > 1:
        if batch_size % process_count:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{process_count} processes")

        def gate(mode, rows):
            meta_ok = getattr(dataset, "supports_meta", None)
            if rows <= 0 or (rows % process_count == 0 and callable(meta_ok)
                             and meta_ok(mode)):
                return rows
            warnings.warn(
                f"multi-host {mode} sequence packing DISABLED: the store "
                "has no header-readable metadata (.pt files?) or "
                f"{mode}_pack_rows={rows} does not shard over "
                f"{process_count} processes — falling back to plain "
                "batches. For reference-format .pt corpora, run "
                "scripts/convert_store.py once to regain packing.",
                stacklevel=2)
            return 0

        asr_pack_rows = gate("asr", asr_pack_rows)
        tts_pack_rows = gate("tts", tts_pack_rows)
        pack_buckets = sorted(audio_buckets) if audio_buckets else None
        pack_window = length_group_window
        audio_buckets, length_group_window = None, 0
    else:
        if audio_buckets:
            audio_buckets = sorted(audio_buckets)
        pack_buckets, pack_window = audio_buckets, length_group_window
    meta_mode = process_count > 1
    per = batch_size // process_count
    lo, hi = process_index * per, (process_index + 1) * per
    P = len(dataset.asr_prompt_ids)
    if asr_pack_rows > 0 and asr_pack_len < dataset.max_audio_len + 1 + P:
        raise ValueError(
            f"asr_pack_len={asr_pack_len} cannot fit a max-length segment "
            f"({dataset.max_audio_len} frames + SOA + {P}-token prompt)")
    if tts_pack_rows > 0 and tts_pack_len < dataset.max_text_len + 1:
        raise ValueError(
            f"tts_pack_len={tts_pack_len} cannot fit a max-length segment "
            f"({dataset.max_text_len} tokens + SOA)")
    # the prompt is constant: never pad it narrower than itself
    if asr_text_pad is not None:
        asr_text_pad = min(dataset.max_text_len, max(int(asr_text_pad), P))
    rng = np.random.default_rng(seed)  # orders and tasks
    aug_rng = np.random.default_rng((seed, process_index))  # SpecAugment
    # the window shuffles draw from their own stream, so that grouping
    # does not shift the order and task stream
    group_rng = np.random.default_rng((seed, 0x67726F75))
    epoch = 0
    while epochs is None or epoch < epochs:
        orders = {}
        if dataset.tts_items:
            orders["tts"] = list(rng.permutation(len(dataset.tts_items)))
        if dataset.asr_items:
            orders["asr"] = list(rng.permutation(len(dataset.asr_items)))
        if not orders:
            return
        cursors = {k: 0 for k in orders}
        pending = {k: [] for k in orders}  # length-grouped batches
        carry = {k: [] for k in orders}  # a window's < batch_size leftover
        asr_carry: list = []  # packed-ASR leftovers
        tts_carry: list = []  # packed-TTS leftovers
        tts_pending: list = []  # packed-TTS groups
        yielded = False

        def avail(k):
            if k == "asr" and asr_pack_rows > 0:
                # a pool of >= rows utterances fills every row once
                return bool(asr_carry) or (
                    cursors[k] + asr_pack_rows <= len(orders[k]))
            if k == "tts" and tts_pack_rows > 0:
                return bool(tts_pending or tts_carry) or (
                    cursors[k] + tts_pack_rows <= len(orders[k]))
            return bool(pending[k]) or (
                cursors[k] + batch_size <= len(orders[k]))

        def draw(k):
            ex = dataset.get(k, orders[k][cursors[k]])
            cursors[k] += 1
            return ex

        def mine(k, pool, assign, rows):
            """The examples of the pack rows this process holds: all of
            them, or multi-process its rows / process_count, loaded from
            their dataset indices."""
            if not meta_mode:
                return [[pool[i][0] for i in idxs] for idxs in assign]
            rpp = rows // process_count
            return [[dataset.get(k, pool[i][0]) for i in idxs] for idxs in
                    assign[process_index * rpp:(process_index + 1) * rpp]]

        while True:
            ready = [k for k in orders if avail(k)]
            if not ready:
                break
            task = "tts" if "tts" in ready and (
                "asr" not in ready or rng.random() < task_prob_tts) else "asr"
            n_items = len(orders[task])
            if task == "asr" and asr_pack_rows > 0:
                # pool entries (payload, llm tokens, frames): the loaded
                # example, or multi-process the dataset index with its
                # header metadata (an unreadable header keeps a stub cost
                # in the plan; its owner's failed load zero-masks the slot)
                want = asr_pack_rows * asr_pack_segments
                pool, asr_carry = asr_carry, []
                while len(pool) < want and cursors[task] < n_items:
                    if meta_mode:
                        j = orders[task][cursors[task]]
                        cursors[task] += 1
                        pool.append((j,) + (dataset.meta(task, j) or (P, 1)))
                        continue
                    ex = draw(task)
                    if ex is not None:
                        pool.append((ex, P, min(len(ex.audio),
                                                dataset.max_audio_len)))
                if not pool:
                    continue
                assign, left = plan_pack([e[2] + 1 + P for e in pool],
                                         asr_pack_rows, asr_pack_len,
                                         asr_pack_segments)
                row_items = mine(task, pool, assign, asr_pack_rows)
                batch = materialize_asr_rows(
                    row_items, dataset.asr_prompt_ids, asr_pack_len,
                    asr_pack_segments, dataset.max_audio_len, latent_dim,
                    dataset.max_text_len, training=training, rng=aug_rng)
                asr_carry = [pool[i] for i in left]
                batch["task"] = "asr_packed"
                batch["n_samples"] = sum(ex is not None for row in row_items
                                         for ex in row)
                yielded = True
                yield batch
                continue
            if task == "tts" and tts_pack_rows > 0:
                if not tts_pending:
                    gsize = tts_pack_rows * tts_pack_segments
                    want = gsize * max(pack_window, 1)
                    pool, tts_carry = tts_carry, []
                    while len(pool) < want and cursors[task] < n_items:
                        if meta_mode:
                            j = orders[task][cursors[task]]
                            cursors[task] += 1
                            pool.append((j,) + (dataset.meta(task, j)
                                                or (1, 1)))
                            continue
                        ex = draw(task)
                        if ex is not None:
                            pool.append((ex, min(len(ex.input_ids),
                                                 dataset.max_text_len),
                                         min(len(ex.audio),
                                             dataset.max_audio_len)))
                    if not pool:
                        continue
                    if pack_window > 0:
                        pool.sort(key=lambda e: e[2])  # stable, audio length
                    groups = [pool[i: i + gsize]
                              for i in range(0, len(pool), gsize)]
                    if pack_window > 0:
                        group_rng.shuffle(groups)
                    tts_pending.extend(groups)
                group = tts_pending.pop(0)
                t_aud = dataset.max_audio_len
                if pack_buckets:
                    longest = max(e[2] for e in group)
                    t_aud = next((b for b in pack_buckets if b >= longest),
                                 dataset.max_audio_len)
                assign, left = plan_pack([e[1] + 1 for e in group],
                                         tts_pack_rows, tts_pack_len,
                                         tts_pack_segments)
                row_items = mine(task, group, assign, tts_pack_rows)
                batch = materialize_tts_rows(
                    row_items, tts_pack_len, tts_pack_segments, t_aud,
                    latent_dim, dataset.max_text_len)
                tts_carry.extend(group[i] for i in left)
                batch["task"] = "tts_packed"
                batch["n_samples"] = sum(ex is not None for row in row_items
                                         for ex in row)
                yielded = True
                yield batch
                continue
            if meta_mode:
                idxs = orders[task][cursors[task]:cursors[task] + batch_size]
                cursors[task] += batch_size
                examples = []
                for j in idxs[lo:hi]:
                    ex = dataset.get(task, j)
                    if ex is None:  # a zero stub keeps processes in step
                        ex = CalmExample(
                            input_ids=np.asarray([pad_token_id], np.int32),
                            labels=np.asarray([-100], np.int32),
                            audio=np.zeros((1, latent_dim), np.float32),
                            mode=task)
                    examples.append(ex)
            elif length_group_window > 0:
                if not pending[task]:
                    want = batch_size * length_group_window
                    window, carry[task] = carry[task], []
                    while len(window) < want and cursors[task] < n_items:
                        ex = draw(task)
                        if ex is not None:
                            window.append(ex)
                    window.sort(key=lambda e: len(e.audio))  # stable
                    n_full = len(window) - len(window) % batch_size
                    groups = [window[i: i + batch_size]
                              for i in range(0, n_full, batch_size)]
                    carry[task] = window[n_full:]
                    group_rng.shuffle(groups)
                    pending[task].extend(groups)
                if not pending[task]:
                    break
                examples = pending[task].pop(0)
            else:
                examples = []
                while len(examples) < batch_size and cursors[task] < n_items:
                    ex = draw(task)
                    if ex is not None:
                        examples.append(ex)
                if len(examples) < batch_size:
                    break
            t_aud = dataset.max_audio_len
            if audio_buckets:
                longest = max(len(ex.audio) for ex in examples)
                t_aud = next((b for b in audio_buckets if b >= longest),
                             dataset.max_audio_len)
            batch = collate_calm(
                examples, pad_token_id, dataset.max_text_len, t_aud,
                latent_dim, training=training, rng=aug_rng,
                text_pad=asr_text_pad if task == "asr" else None)
            batch["task"] = task  # host-side routing key
            yielded = True
            yield batch
        if training and not yielded:
            # a zero-batch epoch would repeat forever with epochs=None
            raise ValueError(
                f"no full batch can be formed: dataset has "
                f"{len(dataset.tts_items)} tts + {len(dataset.asr_items)} asr "
                f"items but batch_size={batch_size}; reduce the batch size "
                "or add data")
        epoch += 1
        if not training:
            return


def mel_batch_iterator(dataset: MelDataset, batch_size: int,
                       training: bool = True, seed: int = 0,
                       epochs: Optional[int] = None, process_index: int = 0,
                       process_count: int = 1
                       ) -> Iterator[Dict[str, np.ndarray]]:
    """{"mel": [batch_size, crop_size, n_mels]} batches: a permutation of
    the dataset per epoch from `default_rng(seed)`, training crops from
    `default_rng((seed, process_index))`, the last partial batch dropped,
    a batch with a failed load skipped. A training epoch that yields no
    batch raises (it would repeat forever); eval stops after one epoch.
    Multi-process: batch_size is global and each process yields its
    batch_size / process_count rows of each batch (the same order stream);
    a failed load becomes a zero mel, so the processes stay in step."""
    if process_count > 1 and batch_size % process_count:
        raise ValueError(f"global batch {batch_size} not divisible by "
                         f"{process_count}")
    rng = np.random.default_rng(seed)
    crop_rng = np.random.default_rng((seed, process_index))
    per = batch_size // process_count
    lo, hi = process_index * per, (process_index + 1) * per
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(len(dataset))
        yielded = False
        for i in range(0, len(order) - batch_size + 1, batch_size):
            mels = []
            for j in order[i: i + batch_size][lo:hi]:
                try:
                    mels.append(dataset.get(int(j),
                                            crop_rng if training else None))
                except Exception:
                    if process_count > 1:
                        mels.append(np.zeros((dataset.crop_size, 80),
                                             np.float32))
                    continue
            if len(mels) < hi - lo:
                continue
            yielded = True
            yield {"mel": np.stack(mels)}
        if training and not yielded:
            raise ValueError(
                f"no full batch can be formed: dataset has {len(dataset)} "
                f"items but (global) batch_size={batch_size}; reduce the "
                f"batch size or add data")
        epoch += 1
        if not training:
            return
