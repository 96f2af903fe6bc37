"""Process runtime — device discovery, engine pool, SW-fallback gating.

Parity reference: ``src/qatzip.c`` L2 — ``qzInit`` (:561), the instance pool
with device round-robin shuffle (:716-729), the spin-lock instance grab
(``qzGrabInstance`` :333-366) and the BACKOUT-to-software policy (:510-528).

Device mapping: the "instance pool" is the set of addressable JAX devices; the
per-instance DMA buffer rings become per-device in-flight dispatch slots
(JAX's async dispatch queue plays the role of the 32-deep CPA ring). Failure
to initialise JAX (or finding zero devices) converts to SW-only mode when
``sw_backup`` is set, or a hard QZ_NOSW_NO_HW otherwise — the exact BACKOUT
semantics.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional

from .constants import (
    QZ_OK, QZ_DUPLICATE, QZ_NO_HW, QZ_NOSW_NO_HW,
)
from .utils.debug import qz_log, qz_error


# Re-probe throttle: after a failed bring-up, this many get_engine calls
# pass before the next (non-blocking) probe attempt — the wait-count
# throttle of the reference's qzInit re-probe (src/qatzip.c:607-610,
# g_is_init_err_throttled) so a dead backend doesn't tax the SW hot path.
REPROBE_WAIT = int(os.environ.get("QZTPU_REPROBE_WAIT", "16"))
# Watchdog bound on a BLOCKING device probe (qzInit): a backend that hangs
# in jax.local_devices() must convert to a loud SW fallback, not a hung
# process.
INIT_TIMEOUT_S = float(os.environ.get("QZTPU_INIT_TIMEOUT", "180"))


class _DeviceProbe:
    """At most one in-flight ``jax.local_devices()`` call, watchdogged.

    Device discovery runs in a daemon thread so a backend hang bounds init
    latency instead of wedging the process; a probe that completes late
    is harvested by the next poll (the re-probe then succeeds instantly).
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._box: dict = {}

    def poll(self, block_s: float = 0.0):
        """Returns (devices|None, error|None). (None, None) = in flight."""
        if self._thread is None:
            box = self._box = {}

            def run(b=box):
                try:
                    import jax
                    # addressable devices only: under jax.distributed
                    # each process drives its local chips (the
                    # per-process instance allocation of the reference
                    # driver conf, config_file/.../c6xx_dev0.conf:118);
                    # global-mesh work goes through parallel/multihost.py
                    b["devices"] = list(jax.local_devices())
                except Exception as e:  # noqa: BLE001 — any backend failure
                    b["error"] = e

            self._thread = threading.Thread(target=run, daemon=True,
                                            name="qztpu-device-probe")
            self._thread.start()
        self._thread.join(block_s)
        if self._thread.is_alive():
            if block_s > 0:
                return None, TimeoutError(
                    f"device probe still hanging after {block_s:.0f}s "
                    "(backend unresponsive)")
            return None, None
        box, self._box = self._box, {}
        self._thread = None        # finished — a later re-probe may retry
        return box.get("devices"), box.get("error")


class Runtime:
    """Singleton process runtime (analog of ``g_process``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.initialized = False
        self.hw_available = False
        self.devices: List = []
        self.platform: Optional[str] = None
        self.gen4 = False  # "new generation" flag: any accelerator backend
        self.last_error: Optional[str] = None   # last bring-up failure
        self._engines = {}
        self._grab_rr = 0
        self._probe = _DeviceProbe()
        self._reprobe_countdown = 0

    def _adopt(self, devices) -> None:
        """Record a successful probe (lock held)."""
        self.devices = list(devices)
        self.platform = self.devices[0].platform if self.devices else None
        self.hw_available = bool(self.devices)
        self.last_error = None if self.hw_available else "no devices found"
        # Any non-CPU backend is "gen4"-class: levels 10-12 (full-reach
        # search) and bigger rings allowed.
        self.gen4 = self.hw_available and self.platform != "cpu"
        if self.hw_available:
            qz_log("qzInit: %d %s device(s)", len(self.devices),
                   self.platform)

    def _fail(self, err) -> None:
        """Record a failed bring-up (lock held) — LOUDLY. Silent SW
        fallback cost round 3 its benchmark; the reason always reaches
        stderr (the reference's QZ_ERROR is likewise unconditional,
        include/qz_utils.h:108)."""
        self.hw_available = False
        self.devices = []
        self.last_error = f"{type(err).__name__}: {err}"
        qz_error("qzInit: device bring-up failed (SW fallback): %s "
                 "[re-probe every %d engine requests; QZTPU_DEBUG=1 "
                 "for detail]", self.last_error, REPROBE_WAIT)
        self._reprobe_countdown = REPROBE_WAIT

    # -- qzInit ------------------------------------------------------------
    def init(self, sw_backup: int = 1,
             block_s: Optional[float] = None) -> int:
        """Bring up the device runtime (qzInit analog, src/qatzip.c:561).

        Returns QZ_OK, QZ_DUPLICATE (already up), QZ_NO_HW (SW-only), or
        QZ_NOSW_NO_HW when no device and sw_backup==0.

        Unlike round 3, a failed bring-up does NOT latch SW mode for the
        life of the process: calling ``init`` again re-probes (blocking,
        watchdog-bounded), and the engine pool re-probes in the
        background with a wait-count throttle — the reference re-probes
        hardware after a failed qzInit the same way (src/qatzip.c:607).
        """
        with self._lock:
            if self.initialized and self.hw_available:
                return QZ_DUPLICATE
            if os.environ.get("QZTPU_FORCE_SW") == "1":
                self.initialized = True
                self.hw_available = False
                self.last_error = "QZTPU_FORCE_SW=1"
                return QZ_NO_HW if sw_backup else QZ_NOSW_NO_HW
            first = not self.initialized
            devices, err = self._probe.poll(
                INIT_TIMEOUT_S if block_s is None else block_s)
            if devices is not None:
                self._adopt(devices)
            elif err is not None:
                self._fail(err)
            elif first:
                # non-blocking call racing an in-flight probe
                self.last_error = "device probe in flight"
                self.hw_available = False
            self.initialized = True
            if not self.hw_available:
                return QZ_NO_HW if sw_backup else QZ_NOSW_NO_HW
            # reaching here means this call brought the device up (the
            # already-up case returned QZ_DUPLICATE at the top) — a
            # successful (re-)init is QZ_OK
            return QZ_OK

    def _background_reprobe(self) -> None:
        """Throttled non-blocking re-probe from the engine hot path."""
        with self._lock:
            if (self.hw_available
                    or os.environ.get("QZTPU_FORCE_SW") == "1"):
                return
            self._reprobe_countdown -= 1
            if self._reprobe_countdown > 0:
                return
            self._reprobe_countdown = REPROBE_WAIT
            devices, err = self._probe.poll(0.0)
            if devices is not None:
                self._adopt(devices)
                if self.hw_available:
                    qz_error("qzInit: device runtime recovered — %d %s "
                             "device(s)", len(self.devices), self.platform)
            elif err is not None:
                self._fail(err)

    # -- engine pool ---------------------------------------------------------
    def get_engine(self, algorithm: str):
        """Build (lazily, once) the accelerated engine for ``algorithm``.

        Analog of qzSetupHW's lazy session/instance setup
        (src/qatzip.c:1203-1269). Returns None when no device is available
        — the caller then routes SW, mirroring the sw_compression fallback
        on qzGrabInstance failure (:2124). An engine that fails to build
        on a present device raises: that is a broken install, not a
        missing device.
        """
        if not self.initialized:
            self.init(1)
        if not self.hw_available:
            self._background_reprobe()   # throttled; harvests late probes
        if not self.hw_available:
            return None
        key = algorithm
        eng = self._engines.get(key)
        if eng is not None:
            return eng
        with self._lock:
            eng = self._engines.get(key)
            if eng is not None:
                return eng
            from .parallel.dispatch import build_engine
            eng = build_engine(algorithm, self.devices)
            if eng is not None:
                self._engines[key] = eng
            return eng

    def grab_device(self):
        """Round-robin device pick (qzGrabInstance analog)."""
        if not self.devices:
            return None
        with self._lock:
            d = self.devices[self._grab_rr % len(self.devices)]
            self._grab_rr += 1
            return d

    def close(self) -> int:
        """qzClose analog — drop engines; keep device handles (cheap)."""
        with self._lock:
            self._engines.clear()
            self.initialized = False
            return QZ_OK


_runtime = Runtime()


def get_runtime() -> Runtime:
    return _runtime


def qz_init(sw_backup: int = 1) -> int:
    return _runtime.init(sw_backup)


def qz_close() -> int:
    return _runtime.close()
