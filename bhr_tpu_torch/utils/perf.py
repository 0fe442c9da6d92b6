"""Performance statistics and CSV logging (the port's own copy of
bhr_tpu/utils/perf.py, which is pure Python; the port imports nothing of
bhr_tpu).

Faithful re-implementation of the reference's perf subsystem:
`PerformanceStats` (reference: src/main.rs:36-197) — 60-sample rolling
windows, 10-frame warm-up exclusion, all-time min/max FPS, FPS standard
deviation — and the CSV `PerfLogger` (reference: src/main.rs:200-262) with
the exact 12-column schema and `measurements/perf_log_<tag>_<ts>.csv`
filename pattern, flushed every frame.
"""

from __future__ import annotations

import csv
import os
import time
from collections import deque

WARMUP_FRAMES = 10  # main.rs:77
MAX_SAMPLES = 60  # main.rs:544 (State::new passes 60)


class PerformanceStats:
    """Rolling frame/CPU/GPU timing statistics (main.rs:36-197)."""

    def __init__(self, max_samples: int = MAX_SAMPLES):
        self.frame_times: deque[float] = deque(maxlen=max_samples)
        self.cpu_times: deque[float] = deque(maxlen=max_samples)
        self.gpu_times: deque[float] = deque(maxlen=max_samples)
        self.max_samples = max_samples
        self.last_frame_time = time.perf_counter()
        self.current_fps = 0.0
        self.current_frame_time = 0.0
        self.current_cpu_time = 0.0
        self.current_gpu_time: float | None = None
        self.all_time_min_fps = float("inf")
        self.all_time_max_fps = 0.0
        self.warmup_frames_remaining = WARMUP_FRAMES

    @property
    def measuring(self) -> bool:
        """True once the warm-up window has passed AND a post-warmup frame
        time has been recorded (main.rs:84-94) — the frame that *completes*
        the warm-up is itself still excluded."""
        return self.warmup_frames_remaining == 0 and len(self.frame_times) > 0

    def update_frame_time(self) -> None:
        now = time.perf_counter()
        frame_time_ms = (now - self.last_frame_time) * 1000.0
        self.last_frame_time = now
        self.record_frame_time_ms(frame_time_ms)

    def record_frame_time_ms(self, frame_time_ms: float) -> None:
        """Record an externally measured per-frame time (the fused-scan app
        path times whole chunks and attributes bracket/chunk to each frame).
        Warm-up frames are counted but not recorded (main.rs:77-94)."""
        if self.warmup_frames_remaining > 0:
            self.warmup_frames_remaining -= 1
            if self.warmup_frames_remaining == 0:
                print("Warmup complete. Starting performance measurement.")
            return
        self.current_frame_time = frame_time_ms
        self.current_fps = 1000.0 / frame_time_ms if frame_time_ms > 0.0 else 0.0
        if self.current_fps > 0.0:
            self.all_time_min_fps = min(self.all_time_min_fps, self.current_fps)
            self.all_time_max_fps = max(self.all_time_max_fps, self.current_fps)
        self.frame_times.append(frame_time_ms)

    def update_cpu_time(self, cpu_time_ms: float) -> None:
        # warm-up-gated like frame times (reference gates all statistics at
        # main.rs:77-94): the first frames include jit compilation, which
        # would otherwise skew avg_cpu_time for the whole first window
        if not self.measuring:
            return
        self.current_cpu_time = cpu_time_ms
        self.cpu_times.append(cpu_time_ms)

    def update_gpu_time(self, gpu_time_ms: float) -> None:
        if not self.measuring:
            return
        self.current_gpu_time = gpu_time_ms
        self.gpu_times.append(gpu_time_ms)

    def avg_fps(self) -> float:
        if not self.frame_times:
            return 0.0
        avg = sum(self.frame_times) / len(self.frame_times)
        return 1000.0 / avg if avg > 0.0 else 0.0

    def min_fps(self) -> float:
        return 0.0 if self.all_time_min_fps == float("inf") else self.all_time_min_fps

    def max_fps(self) -> float:
        return self.all_time_max_fps

    def std_dev_fps(self) -> float:
        if len(self.frame_times) < 2:
            return 0.0
        avg = sum(self.frame_times) / len(self.frame_times)
        var = sum((t - avg) ** 2 for t in self.frame_times) / len(self.frame_times)
        return var**0.5

    def avg_cpu_time(self) -> float:
        return sum(self.cpu_times) / len(self.cpu_times) if self.cpu_times else 0.0

    def avg_gpu_time(self) -> float:
        return sum(self.gpu_times) / len(self.gpu_times) if self.gpu_times else 0.0


CSV_HEADER = [  # main.rs:217-230, exact order
    "elapsed_sec",
    "version",
    "fps",
    "frame_time_ms",
    "cpu_time_ms",
    "gpu_time_ms",
    "avg_fps",
    "min_fps",
    "max_fps",
    "std_dev_fps",
    "avg_cpu_time_ms",
    "avg_gpu_time_ms",
]


class PerfLogger:
    """Per-frame CSV logger (main.rs:200-262)."""

    def __init__(self, version_tag: str, directory: str = "measurements"):
        os.makedirs(directory, exist_ok=True)
        timestamp = time.strftime("%Y%m%d_%H%M%S")
        self.filename = os.path.join(
            directory, f"perf_log_{version_tag}_{timestamp}.csv"
        )
        self._file = open(self.filename, "w", newline="")
        self._writer = csv.writer(self._file)
        self._writer.writerow(CSV_HEADER)
        self.version_tag = version_tag
        self.start_time = time.perf_counter()
        print(f"Performance log created: {self.filename}")

    def log_frame(self, stats: PerformanceStats) -> None:
        elapsed = time.perf_counter() - self.start_time
        self._writer.writerow(
            [
                f"{elapsed:.3f}",
                self.version_tag,
                f"{stats.current_fps:.2f}",
                f"{stats.current_frame_time:.2f}",
                f"{stats.current_cpu_time:.2f}",
                f"{(stats.current_gpu_time or 0.0):.2f}",
                f"{stats.avg_fps():.2f}",
                f"{stats.min_fps():.2f}",
                f"{stats.max_fps():.2f}",
                f"{stats.std_dev_fps():.2f}",
                f"{stats.avg_cpu_time():.2f}",
                f"{stats.avg_gpu_time():.2f}",
            ]
        )
        self._file.flush()  # flushed every frame (main.rs:259)

    def close(self) -> None:
        self._file.close()
