"""frame_ms: the measured window's length over the frames it completed, in
ms. A frame is what the traffic asks: update_scene where the mix moves
something, then render(), ending with the RGBA8 frame in host memory."""


def read(run):
    return run.window_s * 1e3 / len(run.frames)
