"""`render_roofline` (%): the render's bytes (the int16 dry chunks and frame
LFOs read once, the float32 dry, wet and frame LFO written once) at 3.35
TB/s, over the CUDA-event time of `render_batch` on the cell's first batch."""

from benchmark.harness import readers


def read(run):
    return readers.roofline(run, "render")
