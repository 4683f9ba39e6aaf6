"""Video recorder (the reference's ``util/video_recorder.py:13-212``).

The port's own copy of ``furniture_tpu.utils.video_recorder``. It buffers
``[H,W,3]`` frames in host memory (uint8, or floats in [0,1] that it
converts; numpy arrays or tensors on any device, such as the renderer's
``render.to_uint8`` frames) and encodes them on ``close`` with whichever
encoder is installed (imageio, then moviepy). With neither, it writes the
frames to an ``.npz`` file, so nothing is lost.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .logger import logger


class VideoRecorder:
    def __init__(self, record_dir: str = "./videos", prefix: str = "video", fps: int = 15):
        self._dir = record_dir
        self._prefix = prefix
        self._fps = fps
        self._frames: list[np.ndarray] = []
        os.makedirs(record_dir, exist_ok=True)

    def capture_frame(self, frame) -> None:
        if isinstance(frame, torch.Tensor):
            frame = frame.detach().cpu().numpy()
        frame = np.asarray(frame)
        if frame.dtype != np.uint8:
            frame = (np.clip(frame, 0.0, 1.0) * 255).astype(np.uint8)
        self._frames.append(frame)

    def __len__(self) -> int:
        return len(self._frames)

    def close(self, name: str | None = None) -> str | None:
        """Encode and clear the buffered frames: the path written, or None
        when there were none."""
        if not self._frames:
            return None
        base = os.path.join(self._dir, name or self._prefix)
        try:
            import imageio.v2 as imageio

            path = base + ".mp4"
            imageio.mimwrite(path, self._frames, fps=self._fps)
        except Exception:
            try:
                from moviepy.editor import ImageSequenceClip

                path = base + ".mp4"
                ImageSequenceClip(list(self._frames), fps=self._fps).write_videofile(
                    path, logger=None)
            except Exception:
                path = base + ".npz"
                np.savez_compressed(path, frames=np.stack(self._frames))
                logger.info("no video encoder available; saved raw frames to %s", path)
        self._frames = []
        return path
