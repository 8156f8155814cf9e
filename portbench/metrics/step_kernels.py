"""Kernel launches a step of the resident chain over the window: the
program's ``chain.kernels`` counter (each replay's kernel nodes, counted once
at the graph's capture: the prologue's a replay, the WHILE body's a step,
each branch's a run) over its ``chain.steps``.  None where the run recorded
no such counters."""


def read(obs):
    counters = (obs.get("spans") or {}).get("counters", {})
    if not counters.get("chain.steps") or "chain.kernels" not in counters:
        return None
    return counters["chain.kernels"] / counters["chain.steps"]
