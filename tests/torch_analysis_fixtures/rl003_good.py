"""Known-good RL003 fixture: the same ServeDriver honoring its table."""
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
        with self._lock:
            if self._failed is not None:
                raise RuntimeError("the driver failed closed")
            self._streams[request.uid] = request
        self._inbox.put(request)
        return request

    def stats(self):
        with self._lock:
            return {"in_flight": len(self._streams),
                    "max_pending": self.max_pending,
                    "device": str(self.engine.device)}

    def _run(self):
        while self.engine.tick():
            pass
