"""Clock sources for multi-host phase timing.

Reference: ``dl4j-spark/.../time/NTPTimeSource.java`` (and the ``TimeSource``
SPI next to it) — Spark phase timings are stamped with an NTP-corrected
clock so events from different hosts line up on one timeline, with a
system-clock fallback when NTP is unreachable.

The framing is unchanged: multi-host jobs still need comparable
timestamps for the exported timeline (``ui/modules.py`` timeline export,
``parallel/master.py`` TrainingStats). The implementation speaks plain
SNTP (RFC 4330 client mode) over UDP so it needs no dependencies, caches
the measured offset for ``update_frequency`` seconds, and degrades to the
system clock on any failure — the reference's fallback behavior.

A copy of the JAX package's stdlib-only ``parallel/time_source.py``. In
the port the serving tier's circuit breakers and the dispatcher's restart
clock run on it (``ManualTimeSource`` in tests).
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Optional

# seconds between the NTP epoch (1900) and the Unix epoch (1970)
_NTP_DELTA = 2208988800


class TimeSource:
    """SPI: a clock returning milliseconds since the Unix epoch."""

    def current_time_millis(self) -> int:  # pragma: no cover - interface
        raise NotImplementedError

    def ensure_synced(self) -> None:
        """Block until the clock is usable for cross-host comparison (no-op
        for clocks with nothing to measure). Callers that stamp timelines
        (e.g. the TrainingMaster front end) invoke this once at startup so
        the offset never jumps mid-run."""


class SystemClockTimeSource(TimeSource):
    """The local clock (``SystemClockTimeSource`` in the reference)."""

    def current_time_millis(self) -> int:
        return int(time.time() * 1000)


class NTPTimeSource(TimeSource):
    """System clock corrected by an SNTP-measured offset.

    One UDP round trip per ``update_frequency`` window: offset =
    ((t1 - t0) + (t2 - t3)) / 2 from the classic four-timestamp exchange,
    where t0/t3 are local send/receive and t1/t2 the server receive/send.
    On any socket failure the last good offset is kept (0 before the first
    success — i.e. plain system time, the reference's fallback).

    ``current_time_millis`` never blocks: when a window expires it kicks a
    background daemon thread to refresh the offset and returns immediately
    with the last good one. Call ``sync()`` explicitly (e.g. at master
    startup) to block for the first measurement.
    """

    def __init__(self, server: str = "pool.ntp.org", port: int = 123,
                 timeout: float = 2.0, update_frequency: float = 1800.0,
                 eager: bool = True):
        self.server = server
        self.port = port
        self.timeout = timeout
        self.update_frequency = update_frequency
        self._offset_ms = 0.0
        self._last_sync: Optional[float] = None
        self.last_error: Optional[str] = None
        self._sync_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._last_success: Optional[float] = None
        self._sync_thread: Optional[threading.Thread] = None
        if eager:
            # start measuring at construction so the first stamps are already
            # corrected; eager=False keeps the socket quiet until first use
            self._sync_in_background()

    # ------------------------------------------------------------ protocol
    def _query_offset_ms(self) -> float:
        """One SNTP exchange; returns offset in ms (raises on failure)."""
        packet = bytearray(48)
        packet[0] = 0x1B  # LI=0, VN=3, Mode=3 (client)
        t0 = time.time()
        struct.pack_into(">I", packet, 40, int(t0 + _NTP_DELTA))
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.settimeout(self.timeout)
            s.sendto(bytes(packet), (self.server, self.port))
            data, _ = s.recvfrom(48)
        t3 = time.time()
        if len(data) < 48:
            raise ValueError(f"short NTP response ({len(data)} bytes)")

        def ts(off):
            sec, frac = struct.unpack(">II", data[off:off + 8])
            return sec - _NTP_DELTA + frac / 2 ** 32

        t1 = ts(32)  # server receive
        t2 = ts(40)  # server transmit
        return (((t1 - t0) + (t2 - t3)) / 2.0) * 1000.0

    def sync(self) -> bool:
        """Force a sync now; True on success (offset updated).

        Safe to call concurrently with the background refresh: state writes
        are serialized, and a failing exchange never clobbers the result of
        a success that completed after it started.
        """
        started = time.time()
        try:
            offset = self._query_offset_ms()
        except (OSError, ValueError) as e:  # timeout/unreachable/short resp.
            with self._state_lock:
                if self._last_success is None or self._last_success < started:
                    self.last_error = (f"{type(e).__name__}: {e}"
                                       if isinstance(e, OSError) else str(e))
                    self._last_sync = time.time()  # back off until next window
            return False
        with self._state_lock:
            self._offset_ms = offset
            self._last_sync = self._last_success = time.time()
            self.last_error = None
        return True

    @property
    def offset_millis(self) -> float:
        return self._offset_ms

    def ensure_synced(self) -> None:
        """One blocking exchange if no sync attempt has completed yet
        (the eager background attempt may still be in flight)."""
        if self._last_sync is None:
            self.sync()

    def _sync_in_background(self) -> None:
        """Start one refresh thread if none is running (non-blocking)."""
        with self._sync_lock:
            if self._sync_thread is not None and self._sync_thread.is_alive():
                return
            t = threading.Thread(target=self.sync, daemon=True,
                                 name="ntp-time-source-sync")
            self._sync_thread = t
            t.start()

    def current_time_millis(self) -> int:
        now = time.time()
        if (self._last_sync is None
                or now - self._last_sync > self.update_frequency):
            self._sync_in_background()
        return int(now * 1000 + self._offset_ms)


class ManualTimeSource(TimeSource):
    """A clock that only moves when told to — the injectable time source
    the alert engine's state machine and the watchdog tests run on, so
    every window/transition is exercised deterministically (no sleeps)."""

    def __init__(self, start_ms: int = 0):
        self._ms = float(start_ms)
        self._lock = threading.Lock()

    def current_time_millis(self) -> int:
        with self._lock:
            return int(self._ms)

    def advance(self, seconds: float = 0.0, millis: float = 0.0) -> int:
        """Move the clock forward; returns the new time in millis."""
        with self._lock:
            self._ms += seconds * 1000.0 + millis
            return int(self._ms)

    def set_millis(self, ms: float) -> None:
        with self._lock:
            self._ms = float(ms)


_DEFAULT: TimeSource = SystemClockTimeSource()


def get_time_source() -> TimeSource:
    """Process-wide clock used for phase stamps (``TimeSourceProvider``)."""
    return _DEFAULT


def set_time_source(ts: TimeSource) -> None:
    global _DEFAULT
    _DEFAULT = ts
