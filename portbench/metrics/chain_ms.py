"""One trajectory of the resident chain on the device, in ms: the mean
device interval of the window's ``fdtpu.sample.replay`` spans, each the CUDA
events the program's recorder (``fdtpu_torch/utils/profiling.py``) puts
around one replay of the trajectory's graph (every step of the trajectory,
inside the graph's WHILE node).  None where the run recorded no device
interval."""


def read(obs):
    spans = [s for s in (obs.get("spans") or {}).get("spans", [])
             if s["name"] == "fdtpu.sample.replay" and s.get("device_end_ns") is not None]
    if not spans:
        return None
    return 1e-6 * sum(s["device_end_ns"] - s["device_start_ns"] for s in spans) / len(spans)
