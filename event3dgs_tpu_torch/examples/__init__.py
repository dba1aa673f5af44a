"""Runnable example scripts (counterparts of ``event3dgs_tpu/examples/``;
reference `Event_sensor/src/example_*.py`).

The reference ships ~1.6k LoC of near-duplicate research recipes — fifteen
copies of one EXR→events pipeline differing only in hardcoded Windows paths
and camera speeds (`example_EXR_to_events.py`), plus image/video scripts.
Here each family is ONE parameterized, headless script:

- ``images_to_events``: image folder → DVS simulation → `.dat` + frames
  (`example_images_to_events.py:1-77`)
- ``video_to_events``: video file → DVS simulation → `.dat` + overlay video
  (`example_video_to_events.py:1-65`)
- ``exr_to_events``: EXR/radiance sequence → luminance → events, covering
  every Rotate_*/Trans_* recipe via --dt/--cycles/--params
  (`example_EXR_to_events.py:82-998`)
- ``compare_streams``: real-vs-simulated stream metrics (chamfer/gaussian/
  spike-cube) with time-bias and noise sweeps + the metric figure
  (`example_EXR_to_events.py:1016-1298`, `metric_figure.py`)
- ``noise_calibration``: combine measured noise-CDF histograms
  (`noise_calibration.py`)
"""
