"""The share of served rays that the packed path flagged (its sample cap
or the skip march's rounds ran out) and the dense path re-rendered
(`InferStats.fallback_rays` over the rays rendered)."""


def read(r):
    rays = r.counters.get("rays")
    return 100.0 * r.counters["fallback_rays"] / rays if rays else None
