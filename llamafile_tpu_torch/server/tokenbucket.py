"""Per-IP token-bucket DDOS backpressure (the port's own copy of
llamafile_tpu/server/tokenbucket.py).

Behavioral port of llamafiler's tokenbucket (reference: llamafile/server/
tokenbucket.cpp:40-123 — 2^c buckets indexed by the top `cidr` bits of the IP,
background replenisher, acquire charges one token). `--trust` CIDRs bypass
(trust.cpp:24-28).
"""
from __future__ import annotations

import ipaddress
import threading
import time
from typing import List


class TokenBucket:
    def __init__(self, burst: int = 100, rate_hz: float = 1.0, cidr: int = 24,
                 trust: List[str] = ()):
        self.burst = burst
        self.rate = rate_hz
        self.cidr = cidr
        self.buckets = {}
        self.lock = threading.Lock()
        self.trusted = [ipaddress.ip_network(t, strict=False) for t in trust]
        self._last = time.monotonic()

    def _key(self, ip: str) -> int:
        try:
            addr = int(ipaddress.ip_address(ip))
        except ValueError:
            return 0
        return addr >> (32 - self.cidr) if addr < 2 ** 32 else addr >> (128 - self.cidr)

    def is_trusted(self, ip: str) -> bool:
        try:
            a = ipaddress.ip_address(ip)
        except ValueError:
            return False
        if a.is_loopback:
            return True
        return any(a in n for n in self.trusted)

    def acquire(self, ip: str) -> bool:
        """Charge one token; False = rate-limited."""
        if self.is_trusted(ip):
            return True
        now = time.monotonic()
        key = self._key(ip)
        with self.lock:
            elapsed = now - self._last
            if elapsed > 0:                # lazy replenish (no bg thread needed)
                add = elapsed * self.rate
                for k in list(self.buckets):
                    v = self.buckets[k] + add
                    if v >= self.burst:
                        del self.buckets[k]
                    else:
                        self.buckets[k] = v
                self._last = now
            v = self.buckets.get(key, float(self.burst))
            if v < 1.0:
                return False
            self.buckets[key] = v - 1.0
            return True
