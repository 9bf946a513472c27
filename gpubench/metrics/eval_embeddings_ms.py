"""models (``RecModel.eval_embeddings``): ms of the representation a
sweep scores against, host clock from a synchronize before the call to
one after it, mean over the sweeps of a traced run."""


def read(rec):
    spans = rec.spans.get("eval_embeddings")
    return 1e3 * sum(spans) / len(spans) if spans else None
