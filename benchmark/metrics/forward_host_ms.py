"""The host-clock span that the loop puts around the forward call (the
front end, the build, the routing, the staging and the launch), as a mean
per epoch over the window's epochs outside the profiler."""


def read(run):
    if not run.spans:
        return None
    return 1e3 * sum(s["forward"] for s in run.spans) / len(run.spans)
