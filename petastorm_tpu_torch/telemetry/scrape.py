"""The Prometheus scrape endpoint: ``GET /metrics`` over the standard
library's ``http.server``, on one daemon thread.

Counterpart of ``petastorm_tpu/telemetry/scrape.py``.  The body is the text
exposition of every live :class:`~petastorm_tpu_torch.telemetry.registry.MetricsRegistry`
of the process and the decision journal's gauges: per actor, its action and
suppression totals and the age of its last real action (a wedged controller
shows as a growing age).  The command line's ``dispatcher --metrics-port``
serves it; ``refresh`` lets the host bring its derived numbers up to date
before each scrape.
"""

import logging
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

logger = logging.getLogger(__name__)

__all__ = ['render_process_metrics', 'render_decision_metrics', 'start_metrics_server']

_CONTENT_TYPE = 'text/plain; version=0.0.4; charset=utf-8'

_LABEL_SAFE = re.compile(r'[^a-zA-Z0-9_]')


def render_decision_metrics():
    """The decision journal's gauges in the text exposition format: per
    actor, the action and suppression totals summed over every live journal
    of the process, and the least age of its last real action."""
    from petastorm_tpu_torch.telemetry import decisions
    actions, suppressed, last_age = {}, {}, {}
    for journal in decisions.journals():
        for actor, row in journal.summary().items():
            actions[actor] = actions.get(actor, 0) + row.get('actions', 0)
            suppressed[actor] = suppressed.get(actor, 0) + row.get('suppressed', 0)
            last = row.get('last')
            if last and last.get('age_s') is not None:
                age = float(last['age_s'])
                if actor not in last_age or age < last_age[actor]:
                    last_age[actor] = age
    lines = []
    for metric, values, kind in (
            ('petastorm_tpu_decisions_actions_total', actions, 'counter'),
            ('petastorm_tpu_decisions_suppressed_total', suppressed, 'counter'),
            ('petastorm_tpu_decisions_last_action_age_seconds', last_age, 'gauge')):
        if not values:
            continue
        lines.append('# TYPE %s %s' % (metric, kind))
        for actor in sorted(values):
            lines.append('%s{actor="%s"} %s' % (metric, _LABEL_SAFE.sub('_', str(actor)),
                                                values[actor]))
    return '\n'.join(lines)


def render_process_metrics(refresh=None):
    """One scrape's body: every live registry, then the decision gauges.
    ``refresh`` runs first; its failure, or one registry's, costs that part
    of the body, never the scrape."""
    if refresh is not None:
        try:
            refresh()
        except Exception:  # noqa: BLE001 — a scrape is best-effort
            pass
    from petastorm_tpu_torch.telemetry.registry import _LIVE
    chunks = []
    for registry in list(_LIVE):
        try:
            chunks.append(registry.render_prometheus())
        except Exception as e:  # noqa: BLE001 — one sick registry does not end the scrape
            logger.debug('registry %s failed to render: %s', getattr(registry, 'namespace', '?'),
                         e)
    decision_chunk = render_decision_metrics()
    if decision_chunk:
        chunks.append(decision_chunk)
    return '\n'.join(c for c in chunks if c) + '\n'


class _MetricsHandler(BaseHTTPRequestHandler):
    server_version = 'petastorm-tpu-metrics/1.0'

    def do_GET(self):  # noqa: N802 — http.server's API
        if self.path.split('?', 1)[0] not in ('/', '/metrics'):
            self.send_error(404, 'scrape /metrics')
            return
        body = render_process_metrics(refresh=self.server.refresh).encode('utf-8')
        self.send_response(200)
        self.send_header('Content-Type', _CONTENT_TYPE)
        self.send_header('Content-Length', str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, format, *args):  # noqa: A002 — http.server's API
        pass   # a scrape every 15 s does not belong in the dispatcher's log


class _MetricsServer(ThreadingHTTPServer):
    daemon_threads = True
    refresh = None


def start_metrics_server(port, host='0.0.0.0', refresh=None):
    """Serve ``/metrics`` on ``host:port`` (port 0 takes a free one) from a
    daemon thread.  Returns the server: ``server.server_address[1]`` is the
    port, ``server.shutdown()`` stops it."""
    server = _MetricsServer((host, int(port)), _MetricsHandler)
    server.refresh = refresh
    thread = threading.Thread(target=server.serve_forever, name='telemetry-metrics-http',
                              daemon=True)
    thread.start()
    return server
