"""engine.sampler: ms of one ``NegativeSampler.sample_epoch`` call,
host clock from a synchronize before it to one after it, mean over the
window's epochs of a traced run."""


def read(rec):
    spans = rec.spans.get("sample_epoch")
    return 1e3 * sum(spans) / len(spans) if spans else None
