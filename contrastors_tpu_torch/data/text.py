"""Contrastive-pair data: tokenizing collator, streaming shards, local jsonl.

Counterpart of `contrastors_tpu/data/text.py`, with the same on-disk format
and the same numpy batches:

  * gzip JSONL shards addressed by a data-spec YAML ({datasets: [{name,
    bucket, objective{type, columns}, ...}]}), with each bucket's
    counts.json and offsets.json.gz (`data/indexing.py`) for mid-shard
    seeks, or pretokenized token-array shards;
  * every step draws ONE batch from ONE dataset; per-shard quota =
    floor(count / world / rank_batch) * rank_batch;
  * exact resume from a cursor of processed rows and the two RNG states
    (`note_consumed`, `save_state`, `load_state`);
  * objectives paired [query, document], triplet [query, document,
    negatives (sampled or first-k, cycle-padded when short)], self [query];
    kd_scores passed through;
  * prefixes with per-dataset overrides, EOS pinned after truncation,
    per-column max lengths (query 32 / document 256 by default).

Local shards are read with Python's gzip (JAX's package may use its C++
data plane; the bytes are the same); other URLs through fsspec, and the
spec YAML through PyYAML, both imported only where they are read.
`LocalJsonlDataset` also keeps a cursor (the epoch's shuffle state, the next
batch and the sampling RNG), which JAX's has not, so that a resumed run
continues mid-epoch with the batches the uninterrupted run would see.
"""

import gzip
import json
import os
import random
import re
import zlib
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from contrastors_tpu_torch.data.indexing import resolve_shard_key

MAPPED_NAMES = {"paired": ["query", "document"], "self": ["query"], "triplet": ["query", "document", "negative"]}
KEY2PREFIX = {"query": "query", "document": "passage", "negative": "passage"}
DEFAULT_MAX_TOKENS = {"query": 32, "document": 256, "negative": 256}

_BRACE = re.compile(r"\{(\d+)\.\.(\d+)\}")


def expand_urls(pattern: str) -> List[str]:
    """webdataset-style brace expansion: a-{000..002}.jsonl.gz -> 3 urls."""
    m = _BRACE.search(pattern)
    if not m:
        return [pattern]
    lo, hi = m.group(1), m.group(2)
    width = len(lo)
    out = []
    for i in range(int(lo), int(hi) + 1):
        out.extend(expand_urls(pattern[: m.start()] + str(i).zfill(width) + pattern[m.end():]))
    return out


class ShardReadError(RuntimeError):
    """A shard read failed irrecoverably (truncated gzip, IO error); the
    iterator drops the shard and keeps going on one process."""


def validate_eos_placement(input_ids: np.ndarray, attention_mask: np.ndarray, eos_id: int):
    """Check that every sequence's final non-pad token is EOS (required by
    last-token pooling)."""
    lengths = attention_mask.sum(axis=1)
    last = input_ids[np.arange(len(input_ids)), np.maximum(lengths - 1, 0)]
    bad = np.flatnonzero((last != eos_id) & (lengths > 0))
    if bad.size:
        raise ValueError(
            f"sequences {bad[:8].tolist()} do not end in EOS ({eos_id}); "
            f"got trailing tokens {last[bad[:8]].tolist()} — check tokenizer/add_eos"
        )


class TokenizeCollator:
    """Prefix + tokenize + EOS-pin one homogeneous batch into numpy arrays.
    The tokenizer has the Hugging Face call interface and the attributes
    eos_token, eos_token_id and padding_side."""

    def __init__(
        self,
        tokenizer,
        add_eos: bool = True,
        add_prefix: bool = False,
        col_max_length: Optional[Dict[str, int]] = None,
    ):
        self.tokenizer = tokenizer
        if getattr(tokenizer, "padding_side", "right") != "right":
            # the EOS pin, validate_eos_placement and last-token indexing
            # count positions from the left
            tokenizer.padding_side = "right"
        self.add_eos = add_eos and tokenizer.eos_token is not None
        self.add_prefix = add_prefix
        self.col_max_length = col_max_length or dict(DEFAULT_MAX_TOKENS)

    def __call__(
        self,
        samples: List[Dict[str, Any]],
        objective_type: str,
        dataset_name: str = "",
        prefixes: Optional[Dict[str, str]] = None,
        query_only: bool = False,
    ) -> Dict[str, Any]:
        out: Dict[str, Any] = {"dataset_name": dataset_name}
        for col in MAPPED_NAMES[objective_type]:
            if col == "negative":
                continue  # negatives are folded into "document" lists
            texts: List[str] = []
            counts = {len(s[col]) for s in samples if isinstance(s[col], list)}
            if len(counts) > 1:
                # ragged docs-per-query misaligns clip_loss's i * mult
                # labels: cycle-pad every list to the batch max
                m = max(counts)
                if not getattr(self, "_warned_ragged", False):
                    self._warned_ragged = True
                    print(
                        f"[data] ragged negatives per record (counts {sorted(counts)}); "
                        f"cycle-padding to {m} per query — set num_negatives to a "
                        f"fixed value to control this", flush=True,
                    )
                for s in samples:
                    if isinstance(s[col], list) and len(s[col]) < m:
                        v = s[col]  # [positive, neg...]; pad from negatives only
                        if len(v) < 2:
                            raise ValueError(
                                "cannot pad a record with no negatives to the "
                                f"batch's {m} documents per query"
                            )
                        extra = [1 + (j % (len(v) - 1)) for j in range(m - len(v))]
                        s[col] = v + [v[j] for j in extra]
                        if "kd_scores" in s:  # teacher scores track the docs
                            sc = list(s["kd_scores"])
                            s["kd_scores"] = sc + [sc[j] for j in extra]
            for s in samples:
                v = s[col]
                if isinstance(v, list):
                    texts.extend(v)
                else:
                    texts.append(v)
            if self.add_eos:
                texts = [t + self.tokenizer.eos_token for t in texts]
            if self.add_prefix and not (query_only and col != "query"):
                prefix = (prefixes or {}).get(col) or KEY2PREFIX[col]
                texts = [f"{prefix}: {t}" for t in texts]
            enc = self.tokenizer(
                texts,
                padding="max_length",
                truncation=True,
                max_length=self.col_max_length[col],
                return_tensors="np",
            )
            ids = np.asarray(enc["input_ids"]).astype(np.int32)
            mask = np.asarray(enc["attention_mask"]).astype(np.int32)
            if self.add_eos:
                ids[:, -1] = self.tokenizer.eos_token_id
                # truncated rows had their last slot overwritten with EOS;
                # shorter rows got EOS from the appended text
                validate_eos_placement(ids, mask, self.tokenizer.eos_token_id)
            out[f"{col}_input_ids"] = ids
            out[f"{col}_attention_mask"] = mask
        if "kd_scores" in samples[0]:
            out["kd_scores"] = np.asarray([s["kd_scores"] for s in samples], dtype=np.float32)
        return out


def _extract_pair(record: Dict, objective: Dict, num_negatives: int, sample_negatives: bool, rng: random.Random):
    """Returns (paired, neg_indices): neg_indices are the positions of the
    KEPT negatives within the record's negative list (None when the
    objective has no negatives column), so that kd_scores can be gathered
    with the same indices."""
    columns = objective["columns"]
    ctype = objective["type"]
    meta = record.get("metadata", {}).get("objective")
    if meta is not None:
        valid = meta[ctype]
        if columns not in valid:
            raise ValueError(f"columns {columns} invalid for type {ctype}; valid: {valid}")
    paired: Dict[str, Any] = {}
    neg_idx = None
    for mapped, col in zip(MAPPED_NAMES[ctype], columns):
        if mapped == "negative":
            negs = record[col]
            if not negs and num_negatives != 0:
                # padding zero negatives would fake a false negative
                raise ValueError(
                    f"record has no negatives for column {col!r} but the "
                    f"objective requires them"
                )
            idx = list(range(len(negs)))
            if len(negs) > num_negatives >= 0:
                idx = rng.sample(idx, num_negatives) if sample_negatives else idx[:num_negatives]
            elif 0 <= num_negatives and len(idx) < num_negatives:
                # a short record is cycle-padded to the uniform count that
                # clip_loss's labels (i * mult) assume
                idx = [idx[j % len(idx)] for j in range(num_negatives)]
            neg_idx = idx
            paired["document"] = [paired["document"]] + [negs[j] for j in idx]
        else:
            paired[mapped] = record[col]
    return paired, neg_idx


def _is_local(url: str) -> bool:
    return "://" not in url or url.startswith("file://")


def _local(url: str) -> str:
    return url[len("file://"):] if url.startswith("file://") else url


def _open(url: str, mode: str, gz: bool = False):
    """A local path with open / gzip.open; any other URL through fsspec."""
    if _is_local(url):
        return (gzip.open if gz else open)(_local(url), mode)
    import fsspec

    return fsspec.open(url, mode, compression="gzip" if gz else None).open()


def _set_rng_state(rng: random.Random, state):
    rng.setstate((state[0], tuple(state[1]), state[2]))


class StreamingShardDataset:
    def __init__(
        self,
        spec_path: str,
        global_batch_size: int,
        tokenizer,
        seed: int = 42,
        add_eos: bool = True,
        add_prefix: bool = False,
        num_negatives: int = -1,
        weighted_sampling: bool = False,
        infinite: bool = False,
        sample_negatives: bool = False,
        query_max_length: Optional[int] = None,
        document_max_length: Optional[int] = None,
        process_index: int = 0,
        process_count: int = 1,
        state_dir: Optional[str] = None,
        run_name: Optional[str] = None,
        verbose: bool = False,
    ):
        self.rank = process_index
        self.world_size = process_count
        self.rank_batch_size = global_batch_size // self.world_size
        # self.rng drives SHARD SELECTION only, the same draws on every rank;
        # data-dependent draws (negative sampling, corrupt-record refill)
        # live on sample_rng
        self.rng = random.Random(seed)
        self.sample_rng = random.Random(f"{seed}/{self.rank}/sample")
        self.num_negatives = num_negatives
        self.sample_negatives = sample_negatives
        self.weighted_sampling = weighted_sampling
        self.infinite = infinite
        self.verbose = verbose

        col_max = dict(DEFAULT_MAX_TOKENS)
        if query_max_length is not None:
            col_max["query"] = query_max_length
        if document_max_length is not None:
            col_max["document"] = document_max_length
            col_max["negative"] = document_max_length
        self.collator = TokenizeCollator(tokenizer, add_eos, add_prefix, col_max)

        self.path2objective: Dict[str, Dict] = {}
        self.path2offsets: Dict[str, Dict] = {}
        self.path2meta: Dict[str, Dict] = {}
        self.counts: Dict[str, int] = {}
        self.max_per_shard: Dict[str, int] = {}
        self.total_samples = 0
        self._streams: Dict[str, Any] = {}
        self._token_shards: Dict[str, Dict[str, Any]] = {}
        self._consumed_snapshot = None

        self.ds_paths = self._parse_spec(spec_path)
        self.current_paths = list(self.ds_paths)

        state_dir = state_dir or (spec_path.replace(".yaml", "") + "_state")
        os.makedirs(state_dir, exist_ok=True)
        suffix = f"_{run_name}" if run_name else ""
        self.cursor_path = os.path.join(state_dir, f"rank_{self.rank}_processed{suffix}.json")
        self._cursor = {p: 0 for p in self.ds_paths}

    def _parse_spec(self, spec_path: str) -> List[str]:
        import yaml

        with open(spec_path) as f:
            spec = yaml.safe_load(f)
        paths: List[str] = []
        for ds in spec["datasets"]:
            urls = expand_urls(ds["bucket"])
            bucket = "/".join(ds["bucket"].split("/")[:-1])
            with _open(f"{bucket}/counts.json", "r") as f:
                counts = json.load(f)
            if "count_per_file" in counts:
                counts = counts["count_per_file"]
            counts = {k.replace("s3://", ""): v for k, v in counts.items()}
            # pretokenized token-array shards have fixed-size records: row
            # arithmetic replaces offsets
            pretok = bool(ds.get("pretokenized")) or all(u.endswith(".tokens") for u in urls)
            if pretok:
                offsets = {}
            else:
                with _open(f"{bucket}/offsets.json.gz", "rb", gz=True) as f:
                    offsets = json.load(f)
                offsets = {k.replace("s3://", ""): v for k, v in offsets.items()}

            name = ds.get("name") or Path(bucket).name
            prefixes = None
            if ds.get("query_prefix"):
                prefixes = {
                    "query": ds["query_prefix"],
                    "document": ds.get("document_prefix", ds["query_prefix"]),
                    "negative": ds.get("document_prefix", ds["query_prefix"]),
                }
            for url in urls:
                key = resolve_shard_key(url, counts)
                n = counts[key]
                quota = (n // self.world_size // self.rank_batch_size) * self.rank_batch_size
                if quota == 0:
                    continue
                paths.append(url)
                self.counts[url] = n
                self.max_per_shard[url] = quota
                self.total_samples += quota * self.world_size
                self.path2objective[url] = ds["objective"]
                self.path2offsets[url] = None if pretok else offsets[key]
                self.path2meta[url] = {
                    "name": name,
                    "prefixes": prefixes,
                    "kd_loss": ds.get("kd_loss", False),
                    "query_only": ds.get("query_only", False),
                    "pretokenized": pretok,
                }
        if not paths:
            raise ValueError(f"no usable shards in {spec_path} for batch {self.rank_batch_size}")
        return paths

    # -- cursor: kept in memory, written on save_state ------------------------
    def _flush_cursor(self, path: str, cursor: Optional[Dict[str, int]] = None):
        with open(path, "w") as f:
            json.dump(self._cursor if cursor is None else cursor, f, indent=1)

    def note_consumed(self, snapshot: Dict[str, Any]):
        """Record the state as of the last batch the trainer consumed. The
        prefetch thread reads ahead, so the live cursor and RNGs may be past
        it; each batch carries its own post-batch snapshot, and save_state
        prefers the one handed back here."""
        self._consumed_snapshot = snapshot

    def save_state(self, ckpt_dir: str):
        os.makedirs(ckpt_dir, exist_ok=True)
        snap = self._consumed_snapshot
        # never roll self._cursor back in place: the prefetch thread reads it
        cur = snap["cursor"] if snap is not None else None
        self._flush_cursor(os.path.join(ckpt_dir, f"rank_{self.rank}_processed.json"), cur)
        self._flush_cursor(self.cursor_path, cur)
        rng_state = snap["rng"] if snap is not None else self.rng.getstate()
        samp_state = snap["sample_rng"] if snap is not None else self.sample_rng.getstate()
        with open(os.path.join(ckpt_dir, f"rank_{self.rank}_rng.json"), "w") as f:
            json.dump({"rng": rng_state, "sample_rng": samp_state}, f)

    def load_state(self, ckpt_dir: str):
        with open(os.path.join(ckpt_dir, f"rank_{self.rank}_processed.json")) as f:
            processed = json.load(f)
        self._cursor = dict(processed)
        self.current_paths = [p for p in self.ds_paths if processed.get(p, 0) < self.max_per_shard[p]]
        rng_path = os.path.join(ckpt_dir, f"rank_{self.rank}_rng.json")
        if os.path.exists(rng_path):
            with open(rng_path) as f:
                st = json.load(f)
            _set_rng_state(self.rng, st["rng"])
            _set_rng_state(self.sample_rng, st["sample_rng"])

    def __len__(self):
        return self.total_samples

    # -- reading -------------------------------------------------------------
    def _get_stream(self, url: str):
        if url not in self._streams:
            if _is_local(url):
                # local shards: the C++ data plane's inflate with forward
                # seeks (native/), else Python's gzip
                from contrastors_tpu_torch.native import get_lib, NativeGzipStream

                self._streams[url] = NativeGzipStream(_local(url)) if get_lib() else gzip.open(_local(url), "rb")
            else:
                import fsspec

                fs = fsspec.filesystem(url.split("://")[0])
                self._streams[url] = fs.open(url, "rb", compression="gzip", cache_type="background",
                                             block_size=2**20)
        return self._streams[url]

    def _read_rank_batch(self, url: str, already: int) -> List[Dict]:
        """rank_batch_size records at global row already*world +
        rank*rank_batch. Corrupt records are skipped and the batch refilled
        by duplicating good ones; stream errors raise ShardReadError."""
        offsets = self.path2offsets[url]
        start_row = already * self.world_size + self.rank * self.rank_batch_size
        first = offsets[str(start_row)][0]
        last = offsets[str(start_row + self.rank_batch_size - 1)][1]
        try:
            stream = self._get_stream(url)
            if stream.tell() != first:
                stream.seek(first)
            blob = stream.read(last - first)
        except (OSError, EOFError, ValueError, zlib.error) as e:  # truncated gzip, IO error
            self._streams.pop(url, None)  # stream state is unknown; reopen next time
            raise ShardReadError(f"stream error in {url} @ row {start_row}: {e}") from e
        if len(blob) < last - first:
            self._streams.pop(url, None)
            raise ShardReadError(f"short read in {url} @ row {start_row}: got {len(blob)} of {last - first} bytes")
        records = []
        bad = 0
        for i in range(start_row, start_row + self.rank_batch_size):
            s, e = offsets[str(i)]
            try:
                records.append(json.loads(blob[s - first : e - first].decode()))
            except (UnicodeDecodeError, json.JSONDecodeError) as exc:
                bad += 1
                print(f"[data] skipping corrupt record {i} in {url}: {exc}", flush=True)
        if not records:
            raise ShardReadError(f"all {self.rank_batch_size} records corrupt in {url} @ {start_row}")
        if bad:
            fill = self.sample_rng.choices(records, k=bad)
            print(f"[data] refilled {bad} corrupt records in {url} by duplication", flush=True)
            records = records + fill
        return records

    def _load_token_shard(self, url: str) -> Dict[str, Any]:
        """Memory-map a .tokens shard's column arrays (cached per url) and
        check its baked settings against this run's."""
        if url not in self._token_shards:
            d = _local(url)
            try:
                with open(os.path.join(d, "meta.json")) as f:
                    meta = json.load(f)
                sh: Dict[str, Any] = {"meta": meta}
                for name in os.listdir(d):
                    if name.endswith(".npy"):
                        sh[name[:-4]] = np.load(os.path.join(d, name), mmap_mode="r")
            except (OSError, ValueError) as e:
                raise ShardReadError(f"cannot open token shard {url}: {e}") from e
            has_negs = "negative" in MAPPED_NAMES.get(meta.get("objective_type"), [])
            if self.num_negatives >= 0 and has_negs:
                m = meta.get("docs_per_query", 1)
                if m != self.num_negatives + 1:
                    raise ValueError(
                        f"{url} was pretokenized with {m - 1} negatives per "
                        f"query but the config asks for {self.num_negatives}"
                    )
            pmeta = self.path2meta.get(url, {})
            runtime = {
                "add_eos": self.collator.add_eos,
                "add_prefix": self.collator.add_prefix,
                "prefixes": pmeta.get("prefixes"),
                "query_only": pmeta.get("query_only", False),
            }
            for k, want in runtime.items():
                if k in meta and meta[k] != want:
                    raise ValueError(f"{url} was pretokenized with {k}={meta[k]!r} but the "
                                     f"run config uses {k}={want!r}")
            for col, spec in meta.get("columns", {}).items():
                want_len = self.collator.col_max_length.get(col)
                if want_len is not None and spec["max_length"] != want_len:
                    raise ValueError(f"{url} column {col!r} was pretokenized at "
                                     f"max_length={spec['max_length']} but the run config uses {want_len}")
            self._token_shards[url] = sh
        return self._token_shards[url]

    def _read_token_batch(self, url: str, already: int) -> Dict[str, Any]:
        """The rank's window of a pretokenized shard: an mmap slice, masks
        rebuilt from the lengths (right-padded by the collator's contract)."""
        sh = self._load_token_shard(url)
        n_pairs = sh["meta"]["n_pairs"]
        rb = self.rank_batch_size
        start = already * self.world_size + self.rank * rb
        out: Dict[str, Any] = {}
        try:
            for col, spec in sh["meta"]["columns"].items():
                m = spec["rows"] // n_pairs
                lo, hi = start * m, (start + rb) * m
                ids = np.asarray(sh[f"{col}_input_ids"][lo:hi], dtype=np.int32)
                lens = np.asarray(sh[f"{col}_lengths"][lo:hi])
                if ids.shape[0] < rb * m:
                    raise ShardReadError(f"short token window in {url} @ pair {start}: "
                                         f"{ids.shape[0]} of {rb * m} rows")
                L = ids.shape[1]
                out[f"{col}_input_ids"] = ids
                out[f"{col}_attention_mask"] = (np.arange(L, dtype=np.int32)[None, :] < lens[:, None]).astype(np.int32)
            if sh["meta"].get("kd_scores"):
                kd = np.asarray(sh["kd_scores"][start : start + rb], np.float32)
                if kd.shape[0] < rb:
                    raise ShardReadError(f"short kd_scores window in {url} @ pair {start}: {kd.shape[0]} of {rb} rows")
                out["kd_scores"] = kd
        except OSError as e:  # mmap IO error mid-read
            self._token_shards.pop(url, None)
            raise ShardReadError(f"token read error in {url} @ pair {start}: {e}") from e
        return out

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        while True:
            while self.current_paths:
                if self.weighted_sampling:
                    weights = [self.counts[p] - self._cursor[p] * self.world_size for p in self.current_paths]
                    url = self.rng.choices(self.current_paths, weights=weights, k=1)[0]
                else:
                    url = self.rng.choice(self.current_paths)

                cursor = self._cursor
                already = cursor[url]
                meta = self.path2meta[url]
                read_window = self._read_token_batch if meta["pretokenized"] else self._read_rank_batch
                try:
                    records = read_window(url, already)
                except ShardReadError as e:
                    # reopen once, then substitute this rank's first window
                    # (keeps per-shard batch counts intact), then give up on
                    # the shard
                    print(f"[data] read failure, retrying: {e}", flush=True)
                    try:
                        records = read_window(url, already)
                    except ShardReadError:
                        try:
                            records = read_window(url, 0)
                            print(f"[data] substituted window 0 of {url}", flush=True)
                        except ShardReadError as e2:
                            if self.world_size > 1:
                                raise  # dropping a shard on one rank desynchronises the shard choice
                            print(f"[data] dropping shard after read failure: {e2}", flush=True)
                            self.current_paths.remove(url)
                            continue
                cursor[url] = already + self.rank_batch_size
                if cursor[url] >= self.max_per_shard[url]:
                    self.current_paths.remove(url)
                    s = self._streams.pop(url, None)
                    if s is not None:
                        s.close()
                    self._token_shards.pop(url, None)

                if meta["pretokenized"]:
                    batch = dict(records)
                    batch["dataset_name"] = meta["name"]
                else:
                    objective = self.path2objective[url]
                    pairs = []
                    for r in records:
                        p, neg_idx = _extract_pair(r, objective, self.num_negatives, self.sample_negatives,
                                                   self.sample_rng)
                        if meta["kd_loss"]:
                            neg_scores = r["negatives_scores"]
                            p["kd_scores"] = [r["document_score"]] + [neg_scores[j] for j in (neg_idx or [])]
                        pairs.append(p)
                    batch = self.collator(pairs, objective["type"], dataset_name=meta["name"],
                                          prefixes=meta["prefixes"], query_only=meta["query_only"])
                # the post-batch cursor and RNG states travel with the batch,
                # so that the consumer checkpoints what it trained on
                batch["cursor_snapshot"] = {
                    "cursor": dict(cursor),
                    "rng": self.rng.getstate(),
                    "sample_rng": self.sample_rng.getstate(),
                }
                yield batch
            if not self.infinite:
                return
            self.current_paths = list(self.ds_paths)
            self._cursor = {p: 0 for p in self.ds_paths}


class LocalJsonlDataset:
    """Map-style loader over local jsonl(.gz) files, for finetune-scale
    data. Each batch carries a cursor snapshot: the shuffle RNG's state
    before its epoch's shuffle, the next batch of that epoch, and the
    sampling RNG's state after it."""

    def __init__(
        self,
        files: List[str],
        global_batch_size: int,
        tokenizer,
        objective: Optional[Dict] = None,
        seed: int = 42,
        add_eos: bool = True,
        add_prefix: bool = False,
        num_negatives: int = -1,
        sample_negatives: bool = False,
        query_max_length: Optional[int] = None,
        document_max_length: Optional[int] = None,
        shuffle: bool = True,
        process_index: int = 0,
        process_count: int = 1,
        dataset_name: str = "local",
        infinite: bool = False,
    ):
        self.records = []
        for path in files:
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rt") as f:
                for line in f:
                    line = line.strip()
                    if line:
                        self.records.append(json.loads(line))
        self.objective = objective or {"type": "paired", "columns": ["query", "document"]}
        # the epoch shuffle is the same on every rank; negative sampling
        # draws per rank
        self.rng = random.Random(seed)
        self.sample_rng = random.Random(f"{seed}/{process_index}/sample")
        self.shuffle = shuffle
        self.rank = process_index
        self.world = process_count
        self.rank_batch = global_batch_size // process_count
        self.num_negatives = num_negatives
        self.sample_negatives = sample_negatives
        self.dataset_name = dataset_name
        self.infinite = infinite
        col_max = dict(DEFAULT_MAX_TOKENS)
        if query_max_length:
            col_max["query"] = query_max_length
        if document_max_length:
            col_max["document"] = document_max_length
            col_max["negative"] = document_max_length
        self.collator = TokenizeCollator(tokenizer, add_eos, add_prefix, col_max)
        self._start_batch = 0
        self._consumed_snapshot = None

    def __len__(self):
        per_rank = len(self.records) // self.world // self.rank_batch
        return per_rank * self.world * self.rank_batch

    def num_batches(self):
        return len(self.records) // self.world // self.rank_batch

    def note_consumed(self, snapshot: Dict[str, Any]):
        """Record the cursor of the last batch the trainer consumed (the
        prefetch thread may have read ahead of it)."""
        self._consumed_snapshot = snapshot

    def save_state(self, ckpt_dir: str):
        if self._consumed_snapshot is None:
            return  # nothing consumed yet: a resumed run starts at the beginning
        os.makedirs(ckpt_dir, exist_ok=True)
        with open(os.path.join(ckpt_dir, f"rank_{self.rank}_local_cursor.json"), "w") as f:
            json.dump(self._consumed_snapshot, f)

    def load_state(self, ckpt_dir: str):
        path = os.path.join(ckpt_dir, f"rank_{self.rank}_local_cursor.json")
        if not os.path.exists(path):
            return
        with open(path) as f:
            snap = json.load(f)
        _set_rng_state(self.rng, snap["epoch_rng"])
        _set_rng_state(self.sample_rng, snap["sample_rng"])
        self._start_batch = snap["next_batch"]

    def __iter__(self):
        while True:
            epoch_rng = self.rng.getstate()
            order = list(range(len(self.records)))
            if self.shuffle:
                self.rng.shuffle(order)
            n = self.num_batches()
            start, self._start_batch = self._start_batch, 0
            for b in range(start, n):
                idx = order[(b * self.world + self.rank) * self.rank_batch :][: self.rank_batch]
                pairs = [
                    _extract_pair(self.records[i], self.objective, self.num_negatives,
                                  self.sample_negatives, self.sample_rng)[0]
                    for i in idx
                ]
                batch = self.collator(pairs, self.objective["type"], dataset_name=self.dataset_name)
                batch["cursor_snapshot"] = {"epoch_rng": epoch_rng, "next_batch": b + 1,
                                            "sample_rng": self.sample_rng.getstate()}
                yield batch
            if not self.infinite:
                return
