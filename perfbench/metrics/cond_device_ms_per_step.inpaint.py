"""The inpainting condition's device time per replayed training step, in
ms: the device time of the profiled stretch's replays of the step's CUDA
graph that lies in its `condition` phase (the masked scan's posterior
draw, its VAE encode, the mask's resize and the concat), over the replays
(perfbench/graph_phases.py). A program whose capture keeps no phases, or
a step with no condition, reads nothing."""


def read(record, work):
    split = record.get("device_ms_by_graph_phase") or {}
    if record.get("kind") != "train" or "condition" not in split.get(
            "ms", {}):
        return None
    return split["ms"]["condition"] / split["replays"]
