"""MTEB evaluation harness, counterpart of `contrastors_tpu/eval/eval_mteb.py`:
the task lists, the per-type prefixes (`task_prefixes`), `run_mteb` over a
loaded model and tokenizer, and `main`, which loads a local checkpoint.

With --local_data_dir the tasks run from local data through the offline
runner `eval/mini_mteb.py`; without it the `mteb` package is needed, and
its absence raises, as in JAX.

  python -m contrastors_tpu_torch.eval.eval_mteb --model_name <local dir> \
      --local_data_dir <dir> [--tasks T ...] [--seq_len 512] [--batch_size 64] \
      [--binarize] [--matryoshka_dim 256] [--output_dir mteb_results] \
      [--device cuda] [--dtype bf16]
"""

import argparse
from typing import Optional, Sequence

TASK_LIST_CLASSIFICATION = [
    "AmazonCounterfactualClassification",
    "AmazonPolarityClassification",
    "AmazonReviewsClassification",
    "Banking77Classification",
    "EmotionClassification",
    "ImdbClassification",
    "MassiveIntentClassification",
    "MassiveScenarioClassification",
    "MTOPDomainClassification",
    "MTOPIntentClassification",
    "ToxicConversationsClassification",
    "TweetSentimentExtractionClassification",
]
TASK_LIST_CLUSTERING = [
    "ArxivClusteringP2P",
    "ArxivClusteringS2S",
    "BiorxivClusteringP2P",
    "BiorxivClusteringS2S",
    "MedrxivClusteringP2P",
    "MedrxivClusteringS2S",
    "RedditClustering",
    "RedditClusteringP2P",
    "StackExchangeClustering",
    "StackExchangeClusteringP2P",
    "TwentyNewsgroupsClustering",
]
TASK_LIST_PAIR_CLASSIFICATION = [
    "SprintDuplicateQuestions",
    "TwitterSemEval2015",
    "TwitterURLCorpus",
]
TASK_LIST_RERANKING = [
    "AskUbuntuDupQuestions",
    "MindSmallReranking",
    "SciDocsRR",
    "StackOverflowDupQuestions",
]
TASK_LIST_RETRIEVAL = [
    "ArguAna",
    "ClimateFEVER",
    "CQADupstackAndroidRetrieval",
    "CQADupstackEnglishRetrieval",
    "CQADupstackGamingRetrieval",
    "CQADupstackGisRetrieval",
    "CQADupstackMathematicaRetrieval",
    "CQADupstackPhysicsRetrieval",
    "CQADupstackProgrammersRetrieval",
    "CQADupstackStatsRetrieval",
    "CQADupstackTexRetrieval",
    "CQADupstackUnixRetrieval",
    "CQADupstackWebmastersRetrieval",
    "CQADupstackWordpressRetrieval",
    "DBPedia",
    "FEVER",
    "FiQA2018",
    "HotpotQA",
    "MSMARCO",
    "NFCorpus",
    "NQ",
    "QuoraRetrieval",
    "SCIDOCS",
    "SciFact",
    "Touche2020",
    "TRECCOVID",
]
TASK_LIST_STS = [
    "BIOSSES",
    "SICK-R",
    "STS12",
    "STS13",
    "STS14",
    "STS15",
    "STS16",
    "STS17",
    "STS22",
    "STSBenchmark",
    "SummEval",
]
TASK_LIST = (
    TASK_LIST_CLASSIFICATION
    + TASK_LIST_CLUSTERING
    + TASK_LIST_PAIR_CLASSIFICATION
    + TASK_LIST_RERANKING
    + TASK_LIST_RETRIEVAL
    + TASK_LIST_STS
)

# per-task-type prefixes
TYPE2PREFIX = {
    "classification": "classification",
    "clustering": "clustering",
    "pair_classification": "classification",
    "reranking": "classification",
    "retrieval": ("search_query", "search_document"),
    "sts": "classification",
}


def task_prefixes(task_name: str):
    if task_name in TASK_LIST_RETRIEVAL:
        return TYPE2PREFIX["retrieval"]
    if task_name in TASK_LIST_CLUSTERING:
        p = TYPE2PREFIX["clustering"]
    else:
        p = "classification"
    return (p, p)


def mteb_runner(local_data_dir: Optional[str] = None):
    """The module whose MTEB class runs the tasks: the offline runner over
    `local_data_dir`, else the `mteb` package, which must be installed."""
    if local_data_dir:
        from contrastors_tpu_torch.eval import mini_mteb

        mini_mteb.set_data_dir(local_data_dir)
        return mini_mteb
    try:
        import mteb
    except ImportError as e:
        raise SystemExit(
            "the `mteb` package is not installed; install it where there is network, or pass "
            "--local_data_dir to run the offline mini_mteb tasks."
        ) from e
    return mteb


def run_mteb(module, tokenizer, tasks: Optional[Sequence[str]] = None, output_dir: str = "mteb_results",
             local_data_dir: Optional[str] = None, seq_len: int = 512, batch_size: int = 64,
             binarize: bool = False, matryoshka_dim: Optional[int] = None) -> dict:
    """Every task of `tasks` (default TASK_LIST) through a loaded BiEncoder
    with the task type's prefixes, each task's result JSON written to
    output_dir. Returns {task: result} (the runner's)."""
    from contrastors_tpu_torch.eval.encoder import Encoder

    runner = mteb_runner(local_data_dir)
    results = {}
    for task in tasks or TASK_LIST:
        qp, dp = task_prefixes(task)
        enc = Encoder(
            module, tokenizer, seq_len=seq_len, batch_size=batch_size, query_prefix=qp, document_prefix=dp,
            binarize=binarize, matryoshka_dim=matryoshka_dim,
        )
        evaluation = runner.MTEB(tasks=[task], task_langs=["en"])
        results.update(evaluation.run(enc, output_folder=output_dir, eval_splits=["test"]) or {})
    return results


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="MTEB evaluation")
    parser.add_argument("--model_name", required=True)
    parser.add_argument("--seq_len", type=int, default=512)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--binarize", action="store_true")
    parser.add_argument("--matryoshka_dim", type=int, default=None)
    parser.add_argument("--output_dir", default="mteb_results")
    parser.add_argument("--tasks", nargs="*", default=None)
    parser.add_argument(
        "--local_data_dir", default=None,
        help="run tasks from local data via the offline mini_mteb runner "
        "(<dir>/<TaskName>/, see eval/mini_mteb.py) instead of the mteb package",
    )
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"])
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    mteb_runner(args.local_data_dir)  # refuse before loading a model

    from contrastors_tpu_torch.eval.encoder import auto_tokenizer, load_encoder_model

    module, _ = load_encoder_model(args.model_name, "mean", args.dtype, args.device)
    return run_mteb(module, auto_tokenizer(args.model_name), args.tasks, args.output_dir, args.local_data_dir,
                    args.seq_len, args.batch_size, args.binarize, args.matryoshka_dim)


if __name__ == "__main__":
    main()
