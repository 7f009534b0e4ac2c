"""Known-bad RL003 fixture: a ServeDriver breaking its ownership table (a
locked attr read outside the lock, the engine's scheduler state touched
from a transport method, config mutated after __init__, an attr the table
does not know about)."""
import queue
import threading


class DiffusionServeEngine:
    def __init__(self, device):
        self.device = device
        self._pending = []

    def tick(self):
        return list(self._pending)


class ServeDriver:
    def __init__(self, engine):
        self.engine = engine
        self.max_pending = 4
        self._lock = threading.Lock()
        self._inbox = queue.Queue()
        self._streams = {}
        self._thread = None
        self._failed = None

    def submit(self, request):
        if self._failed is not None:
            raise RuntimeError("the driver failed closed")
        with self._lock:
            self._streams[request.uid] = request
        self._inbox.put(request)
        self.engine._pending.append(request)
        self.max_pending = 8
        self._ticks = 0
        return request
