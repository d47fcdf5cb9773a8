"""launches.<cell>: device operations (kernels, copies, sets) in the traced
window's device trace, per training step (a unit's ``steps``) or per unit
(a request, a grid call)."""


def read(record):
    n = sum(u.get("steps", 1) for u in record["units"] if not u.get("failed"))
    return record["trace"].launches() / n if n else None
