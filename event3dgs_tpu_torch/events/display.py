"""Event stream visualization (offline).

The port's copy of ``event3dgs_tpu/events/display.py`` (numpy, as there).

Equivalent of the reference's cv2-window `EventDisplay`
(`Event_sensor/src/event_display.py:6-68`) for a headless environment:
accumulates events into refresh-rate frames (binary polarity or
exponentially-decayed time surface) and returns/saves them instead of
opening a window.
"""

from __future__ import annotations

import os

import numpy as np


class EventDisplay:
    """Accumulate an event stream into display frames every `frametime` µs."""

    def __init__(
        self,
        width: int,
        height: int,
        frametime: float = 33_000.0,
        mode: str = "binary",  # "binary" | "time_surface"
        tau: float = 30_000.0,
        out_dir: str | None = None,
    ):
        self.width = width
        self.height = height
        self.frametime = frametime
        self.mode = mode
        self.tau = tau
        self.out_dir = out_dir
        self.frames: list[np.ndarray] = []
        self._last_t = np.zeros((height, width), np.float64)
        self._last_p = np.zeros((height, width), np.int8)
        self._frame_events: list[tuple] = []
        self._next_refresh = frametime

    def update(self, t, x, y, p):
        """Feed a batch of events (time-ordered); emits frames as the clock
        crosses refresh boundaries."""
        t = np.asarray(t, np.float64)
        x = np.asarray(x, np.int64)
        y = np.asarray(y, np.int64)
        p = np.asarray(p, np.int64)
        start = 0
        while start < len(t):
            cut = np.searchsorted(t, self._next_refresh)
            seg = slice(start, cut)
            if cut > start:
                self._ingest(t[seg], x[seg], y[seg], p[seg])
            if cut < len(t):
                self._emit_frame()
                self._next_refresh += self.frametime
                start = cut
            else:
                break

    def _ingest(self, t, x, y, p):
        self._last_t[y, x] = t
        self._last_p[y, x] = np.where(p > 0, 1, -1)

    def _emit_frame(self):
        now = self._next_refresh
        if self.mode == "time_surface":
            decay = np.exp(-(now - self._last_t) / self.tau)
            decay[self._last_t == 0] = 0.0
            img = 0.5 + 0.5 * decay * self._last_p
        else:
            fresh = (now - self._last_t) < self.frametime
            img = np.full((self.height, self.width), 0.5)
            img[fresh & (self._last_p > 0)] = 1.0
            img[fresh & (self._last_p < 0)] = 0.0
        self.frames.append(img.astype(np.float32))
        if self.out_dir:
            from event3dgs_tpu_torch.utils.image_io import save_image

            os.makedirs(self.out_dir, exist_ok=True)
            save_image(
                os.path.join(self.out_dir, f"disp_{len(self.frames):05d}.png"),
                img,
            )


def display_events_frame(
    events, t_begin: float, t_end: float, width: int = 1280, height: int = 720
) -> np.ndarray:
    """One BGR count frame from a structured-event window.

    Reference `EventsData.display_events` (`event_file_io.py:549-574`): ON
    counts ×10 into the red (BGR index 2) channel, OFF counts ×10 into
    blue — uint8 with the reference's deliberate wrap-around semantics.
    """
    sel = (events["t"] >= t_begin) & (events["t"] <= t_end)
    ev = events[sel]
    img = np.zeros((height, width, 3), np.uint8)
    on = np.zeros((height, width), np.uint8)
    off = np.zeros((height, width), np.uint8)
    ys = ev["y"].astype(int)
    xs = ev["x"].astype(int)
    np.add.at(on, (ys, xs), (ev["p"] == 1).astype(np.uint8))
    np.add.at(off, (ys, xs), (ev["p"] == 0).astype(np.uint8))
    img[:, :, 2] = on * 10
    img[:, :, 0] = off * 10
    return img


def generate_event_video(
    events, t_begin: float, t_end: float, dt: float = 2857 * 2,
    video_name: str = "events.avi", cycles: int = 1,
    width: int = 1280, height: int = 720, fps: int = 30,
) -> str:
    """Render an event stream into a video file (reference
    `generate_video`, `event_file_io.py:575-588`; MJPG instead of H264 —
    codec availability, not semantics)."""
    import cv2

    fourcc = cv2.VideoWriter_fourcc(*"MJPG")
    video = cv2.VideoWriter(video_name, fourcc, fps, (width, height))
    for _ in range(cycles):
        t = t_begin
        while t <= t_end:
            video.write(display_events_frame(events, t, t + dt, width, height))
            t += dt
    video.release()
    return video_name


def event_cloud_3d(events, t_begin: float, t_end: float):
    """(x, y, t) point cloud of an event window with polarity colors.

    Reference `display_events_3D` (`event_file_io.py:643-670`): ON events
    get the blue-ish color [30, 30, 220]/255, OFF events [200, 30, 30]/255.
    Returns (positions [N, 3] f64, colors [N, 3] f64 in [0, 1]); when
    open3d is installed, returns an `o3d.geometry.PointCloud` instead.
    """
    sel = (events["t"] >= t_begin) & (events["t"] <= t_end)
    ev = events[sel]
    positions = np.column_stack(
        (ev["x"].astype(np.float64), ev["y"].astype(np.float64),
         ev["t"].astype(np.float64))
    )
    colors = np.empty_like(positions)
    on = ev["p"] == 1
    colors[on] = np.asarray([30, 30, 220], np.float64) / 255.0
    colors[~on] = np.asarray([200, 30, 30], np.float64) / 255.0
    try:
        import open3d as o3d  # type: ignore

        pc = o3d.geometry.PointCloud()
        pc.points = o3d.utility.Vector3dVector(positions)
        pc.colors = o3d.utility.Vector3dVector(colors)
        return pc
    except ImportError:
        return positions, colors


def generate_comparison_video(
    named_videos: dict, out_path: str, fps: float = 30.0,
    tile: tuple = (640, 360), cols: int = 2,
) -> str:
    """Tile several videos into one labeled comparison grid.

    Headless generalization of the reference's hardcoded six-stream grid
    (`generate_display_video`, `event_file_io.py:588-641`): takes
    {label: video_path} in display order, borders + resizes each frame to
    ``tile``, lays them out ``cols`` per row, stamps the label, and writes
    an MJPG video.  Stops at the shortest stream, like the reference.
    """
    import cv2

    labels = list(named_videos)
    caps = [cv2.VideoCapture(named_videos[k]) for k in labels]
    rows = -(-len(caps) // cols)
    w, h = tile
    writer = cv2.VideoWriter(
        out_path, cv2.VideoWriter_fourcc(*"MJPG"), fps,
        (w * cols, h * rows), True,
    )
    try:
        while True:
            frames = []
            ok_all = True
            for cap in caps:
                ok, frame = cap.read()
                if not ok:
                    ok_all = False
                    break
                frame = cv2.copyMakeBorder(
                    frame, 10, 10, 10, 10, cv2.BORDER_CONSTANT, value=(0, 0, 0)
                )
                frames.append(cv2.resize(frame, (w, h)))
            if not ok_all:
                break
            while len(frames) < rows * cols:
                frames.append(np.zeros((h, w, 3), np.uint8))
            grid = np.vstack([
                np.hstack(frames[r * cols : (r + 1) * cols])
                for r in range(rows)
            ])
            for i, label in enumerate(labels):
                x0 = (i % cols) * w + 10
                y0 = (i // cols) * h + 30
                cv2.putText(grid, label, (x0, y0),
                            cv2.FONT_HERSHEY_SIMPLEX, 1.10, (0, 0, 255), 2)
            writer.write(grid)
    finally:
        for cap in caps:
            cap.release()
        writer.release()
    return out_path
