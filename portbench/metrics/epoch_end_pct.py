"""The fit's epoch ends over its wall, in %: the host wall of the window
fit's ``fdtpu.fit.epoch_end`` spans (everything after an epoch's loss read:
validation, logging, the best-state copy and checkpoint, the resume
snapshot) over its ``fdtpu.fit`` span's (the program's recorder,
``fdtpu_torch/utils/profiling.py``).  The ``fdtpu.fit.callbacks`` spans
inside them are left out: they run the caller's code.  None where the run
recorded no fit."""


def read(obs):
    spans = (obs.get("spans") or {}).get("spans", [])
    fits = [s for s in spans
            if s["name"] == "fdtpu.fit" and s["parent"] is None and s["end_ns"] is not None]
    if not fits:
        return None
    fit = fits[-1]
    wall = fit["end_ns"] - fit["start_ns"]
    ends = {s["id"]: s["end_ns"] - s["start_ns"] for s in spans
            if s["call"] == fit["call"] and s["name"] == "fdtpu.fit.epoch_end"
            and s["end_ns"] is not None}
    callbacks = sum(s["end_ns"] - s["start_ns"] for s in spans
                    if s["name"] == "fdtpu.fit.callbacks" and s["parent"] in ends)
    return 100.0 * (sum(ends.values()) - callbacks) / wall if wall > 0 else None
