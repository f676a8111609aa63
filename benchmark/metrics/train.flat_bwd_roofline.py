"""The flat backward compositing kernel's share of its roofline in
training: the least time of the kept flat calls' counted backward work
(``traffic/peaks.py::flat_work_of``) over the device time of the window's
first ``flat_backward_kernel`` launches, as many as the calls kept. None
where the window composited no flat stream."""


def read(r):
    if r.kind != "train":
        return None
    least, _, kept = r.composite.get("flat_backward", (0.0, 0.0, 0))
    times = [b - a for n, a, b in sorted(r.dev, key=lambda x: x[1])
             if "flat_backward_kernel" in n]
    t = sum(times[:kept])
    return 100.0 * least / t if kept and t > 0 else None
