"""featurize_ms.<cell>: the benchmark's span around the featurizer's calls
on a request's source and target (host numpy: trim, pre-emphasis, mel), as
a mean per request over the whole window."""


def read(record):
    spans = record["spans"].get("featurize")
    return 1e3 * sum(spans) / len(spans) if spans else None
