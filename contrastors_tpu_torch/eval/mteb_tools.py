"""MTEB result post-processing: the CQADupstack merge, the score table and
the model card's metadata. Counterpart of `contrastors_tpu/eval/mteb_tools.py`.

Works on a directory of per-task MTEB result JSONs ({task}.json with a
"test" split of metric values; main_score-style nesting, newer mteb's list
of subsets and language-keyed splits are read too). The 12 CQADupstack
subsets merge into one CQADupstackRetrieval entry before averaging, and a
partial set of them raises.

  python -m contrastors_tpu_torch.eval.mteb_tools {merge,score,meta} \
      --results_dir <dir> [--model_name name]
"""

import argparse
import json
import os
from typing import Any, Dict, List, Optional

from contrastors_tpu_torch.eval.eval_mteb import (
    TASK_LIST_CLASSIFICATION,
    TASK_LIST_CLUSTERING,
    TASK_LIST_PAIR_CLASSIFICATION,
    TASK_LIST_RERANKING,
    TASK_LIST_RETRIEVAL,
    TASK_LIST_STS,
)

CQADUPSTACK_SUBSETS = [
    f"CQADupstack{name}Retrieval"
    for name in (
        "Android", "English", "Gaming", "Gis", "Mathematica", "Physics",
        "Programmers", "Stats", "Tex", "Unix", "Webmasters", "Wordpress",
    )
]

# task type -> dotted path candidates for the headline metric
MAIN_METRIC = {
    "classification": ("accuracy", "main_score"),
    "clustering": ("v_measure", "main_score"),
    "pair_classification": ("cos_sim.ap", "cosine_ap", "main_score"),
    "reranking": ("map", "main_score"),
    "retrieval": ("ndcg_at_10", "main_score"),
    "sts": ("cos_sim.spearman", "cosine_spearman", "main_score"),
}


def task_type(task: str) -> str:
    if task in TASK_LIST_CLASSIFICATION:
        return "classification"
    if task in TASK_LIST_CLUSTERING:
        return "clustering"
    if task in TASK_LIST_PAIR_CLASSIFICATION:
        return "pair_classification"
    if task in TASK_LIST_RERANKING:
        return "reranking"
    if task in TASK_LIST_RETRIEVAL or task.startswith("CQADupstack"):
        return "retrieval"
    if task in TASK_LIST_STS:
        return "sts"
    return "retrieval"


def _get_path(d: Dict, dotted: str):
    node: Any = d
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node


def _test_split(payload: Dict) -> Dict:
    if "test" in payload:
        split = payload["test"]
    elif "scores" in payload and "test" in payload["scores"]:
        split = payload["scores"]["test"]
    else:
        split = payload
    if isinstance(split, list):  # newer mteb: list of per-subset dicts
        split = split[0] if split else {}
    # language-keyed splits ({"en": {...}}): prefer en
    if isinstance(split, dict) and "en" in split and isinstance(split["en"], dict):
        merged = dict(split)
        merged.update(split["en"])
        return merged
    return split


def extract_main_score(task: str, payload: Dict) -> Optional[float]:
    split = _test_split(payload)
    for candidate in MAIN_METRIC[task_type(task)]:
        v = _get_path(split, candidate)
        if isinstance(v, (int, float)):
            return float(v)
    return None


def _flatten_numeric(d: Dict, prefix="") -> Dict[str, float]:
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten_numeric(v, key + "."))
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            out[key] = float(v)
    return out


def merge_cqadupstack(results_dir: str) -> Optional[str]:
    """Average the 12 CQADupstack subset results into CQADupstackRetrieval.json
    (reference merge_cqadupstack.py). Returns the written path, or None if no
    subsets are present. Missing subsets raise — a partial average would
    silently skew the MTEB mean."""
    present = [
        t for t in CQADUPSTACK_SUBSETS if os.path.exists(os.path.join(results_dir, f"{t}.json"))
    ]
    if not present:
        return None
    if len(present) != len(CQADUPSTACK_SUBSETS):
        missing = sorted(set(CQADUPSTACK_SUBSETS) - set(present))
        raise FileNotFoundError(f"CQADupstack subsets missing from {results_dir}: {missing}")

    flats: List[Dict[str, float]] = []
    for t in present:
        with open(os.path.join(results_dir, f"{t}.json")) as f:
            flats.append(_flatten_numeric(_test_split(json.load(f))))
    keys = set(flats[0])
    for fl in flats[1:]:
        keys &= set(fl)
    avg: Dict[str, Any] = {}
    for key in sorted(keys):
        node = avg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = sum(fl[key] for fl in flats) / len(flats)
    out_path = os.path.join(results_dir, "CQADupstackRetrieval.json")
    with open(out_path, "w") as f:
        json.dump({"mteb_dataset_name": "CQADupstackRetrieval", "test": avg}, f, indent=2)
    return out_path


def score_table(results_dir: str) -> Dict[str, Any]:
    """Per-task main scores + per-type and overall averages (reference
    score_mteb.py). CQADupstack subsets fold into the single merged task."""
    merge_cqadupstack(results_dir)
    per_task: Dict[str, float] = {}
    for fname in sorted(os.listdir(results_dir)):
        if not fname.endswith(".json"):
            continue
        task = fname[:-5]
        if task in CQADUPSTACK_SUBSETS:
            continue
        with open(os.path.join(results_dir, fname)) as f:
            payload = json.load(f)
        score = extract_main_score(task, payload)
        if score is not None:
            per_task[task] = score

    by_type: Dict[str, List[float]] = {}
    for task, score in per_task.items():
        by_type.setdefault(task_type(task), []).append(score)
    type_avgs = {t: sum(v) / len(v) for t, v in by_type.items()}
    overall = sum(per_task.values()) / len(per_task) if per_task else float("nan")
    return {"per_task": per_task, "per_type": type_avgs, "average": overall, "n_tasks": len(per_task)}


def mteb_meta(results_dir: str, model_name: str) -> str:
    """Model-card YAML front matter with mteb model-index results
    (reference mteb_meta.py). Returns the README.md path written inside
    results_dir."""
    table = score_table(results_dir)
    lines = [
        "---",
        "tags:",
        "- mteb",
        "model-index:",
        f"- name: {model_name.split('/')[-1]}",
        "  results:",
    ]
    for task, score in sorted(table["per_task"].items()):
        lines += [
            f"  - task:",
            f"      type: {task_type(task)}",
            f"    dataset:",
            f"      name: MTEB {task}",
            f"      type: {task}",
            f"      split: test",
            f"    metrics:",
            f"    - type: main_score",
            f"      value: {score * 100 if score <= 1.0 else score:.4f}",
        ]
    lines.append("---")
    path = os.path.join(results_dir, "README.md")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def main(argv=None):
    parser = argparse.ArgumentParser(description="MTEB results post-processing")
    parser.add_argument("command", choices=["merge", "score", "meta"])
    parser.add_argument("--results_dir", required=True)
    parser.add_argument("--model_name", default="model")
    args = parser.parse_args(argv)
    if args.command == "merge":
        print(merge_cqadupstack(args.results_dir) or "no CQADupstack subsets found")
    elif args.command == "score":
        table = score_table(args.results_dir)
        width = max((len(t) for t in table["per_task"]), default=10)
        for task, score in sorted(table["per_task"].items()):
            print(f"{task:<{width}}  {score:.4f}")
        print("-" * (width + 9))
        for t, v in sorted(table["per_type"].items()):
            print(f"{t:<{width}}  {v:.4f}")
        print(f"{'AVERAGE (' + str(table['n_tasks']) + ' tasks)':<{width}}  {table['average']:.4f}")
    else:
        print(mteb_meta(args.results_dir, args.model_name))


if __name__ == "__main__":
    main()
