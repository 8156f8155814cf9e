"""Share of the window's chain steps that ran a full network forward (the
E²-CRF cache's refreshes), from the program's cache statistics, in %."""


def read(obs):
    w = obs["window"]
    return 100.0 * w["full_steps"] / w["steps"] if w.get("steps") else None
