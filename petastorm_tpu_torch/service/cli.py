"""The data service's command line: run and inspect a fleet.

Counterpart of ``petastorm_tpu/service/cli.py`` (``petastorm-tpu-data-service``),
with its subcommands and flags, run as ``python -m
petastorm_tpu_torch.service.cli``.  One dispatcher, decode workers on any
number of hosts, then a ``ServiceDataLoader`` pointed at the dispatcher from
the training job::

    python -m petastorm_tpu_torch.service.cli dispatcher \\
        --bind tcp://0.0.0.0:7777 --dataset-url file:///data/train --num-consumers 4
    python -m petastorm_tpu_torch.service.cli worker --dispatcher tcp://dispatch:7777
    python -m petastorm_tpu_torch.service.cli status --dispatcher tcp://dispatch:7777

``status`` prints the dispatcher's ``stats`` as JSON; ``drain`` drains one
worker; ``stop`` stops the dispatcher; ``clock`` measures the clock offset
and round trip to it.  ``dispatcher --autoscale`` runs the closed-loop
autoscaler, whose workers are processes of this command line's ``worker``,
and ``--metrics-port`` serves Prometheus text on ``/metrics``.  What the
``worker`` subcommand imports loads neither torch nor JAX.
"""

import argparse
import json
import logging
import sys
import time


def _build_parser():
    parser = argparse.ArgumentParser(
        prog='petastorm-tpu-data-service',
        description='Disaggregated data-loading service (petastorm_tpu_torch.service)')
    sub = parser.add_subparsers(dest='command', required=True)

    d = sub.add_parser('dispatcher', help='run the control plane')
    d.add_argument('--bind', default='tcp://127.0.0.1:7777',
                   help='REP endpoint to serve on (tcp://host:port; port * picks a free one)')
    d.add_argument('--dataset-url', required=True)
    d.add_argument('--num-consumers', type=int, default=1,
                   help='number of consuming training hosts (split i belongs to consumer '
                        'i %% N)')
    d.add_argument('--rowgroups-per-split', type=int, default=2)
    d.add_argument('--lease-ttl-s', type=float, default=10.0)
    d.add_argument('--credits', type=int, default=8)
    d.add_argument('--reader-factory', default='auto', choices=('auto', 'reader', 'batch_reader'))
    d.add_argument('--workers-count', type=int, default=None,
                   help='decode threads per split reader on each worker')
    d.add_argument('--cache-plane-dir', default=None,
                   help='enable the epoch-cache plane: workers publish decoded batches under '
                        'this (host-local) directory and serve later epochs from it')
    d.add_argument('--cache-plane-ram-bytes', type=int, default=None,
                   help='hot /dev/shm tier cap (default 128 MiB)')
    d.add_argument('--cache-plane-disk-bytes', type=int, default=None,
                   help='disk tier cap (default 4 GiB)')
    d.add_argument('--no-cluster-cache', action='store_true',
                   help='disable the cluster cache tier (on whenever the cache plane is): no '
                        'cache-affinity leasing, no serving from the plane without a reader, '
                        'no peer fill; PETASTORM_TPU_NO_CLUSTER_CACHE=1 is the kill switch')
    d.add_argument('--ingest', default='auto', choices=('auto', 'plane', 'off'),
                   help="the ingest plane's mode for every split reader; only 'auto' is "
                        'ported (ROADMAP.md, Queue A item 7)')
    d.add_argument('--ledger-path', default=None,
                   help='durable dispatcher ledger: split states, attempt counts, the cache '
                        'directory and the decision journal persist, and a dispatcher '
                        'restarted on the same path (and port) resumes the job')
    d.add_argument('--drain-timeout-s', type=float, default=30.0,
                   help='how long a draining worker may finish its in-flight splits before '
                        'it deregisters as timed out')
    d.add_argument('--no-telemetry-spans', action='store_true',
                   help="do not ship each split's stage spans on its end header")
    d.add_argument('--max-tenant-jobs', type=int, default=8,
                   help='admission cap on concurrent tenant jobs on this fleet; a '
                        'registration past it is refused with a retry_after_s hint')
    d.add_argument('--tenant-shm-quota-bytes', type=int, default=None,
                   help="a tenant's outstanding shm bytes on each worker; past it its chunks "
                        'take the byte path (default: unlimited)')
    d.add_argument('--tenant-cache-quota-bytes', type=int, default=None,
                   help="a tenant's bytes written into each worker's cache plane; past it "
                        'its splits decode without the plane (default: unlimited)')
    d.add_argument('--autoscale', action='store_true',
                   help='closed-loop autoscaler: spawn workers when leases starve, drain the '
                        'worker with the least cache coverage when the fleet idles; '
                        'PETASTORM_TPU_NO_AUTOSCALE=1 is the kill switch')
    d.add_argument('--autoscale-min-workers', type=int, default=1)
    d.add_argument('--autoscale-max-workers', type=int, default=8)
    d.add_argument('--autoscale-step', type=int, default=1,
                   help='max workers spawned per scale-out')
    d.add_argument('--autoscale-cooldown-s', type=float, default=10.0,
                   help='no further action for this long after any action')
    d.add_argument('--autoscale-starve-s', type=float, default=3.0,
                   help='pending work and no free lease slot must last this long before a '
                        'scale-out')
    d.add_argument('--autoscale-idle-s', type=float, default=30.0,
                   help='an idle fleet must stay so this long before a scale-in')
    d.add_argument('--metrics-port', type=int, default=None,
                   help='serve Prometheus text on http://0.0.0.0:PORT/metrics (port 0 picks a '
                        'free one): every live registry and the decision-journal gauges')

    w = sub.add_parser('worker', help='run one decode worker')
    w.add_argument('--dispatcher', required=True, help='dispatcher endpoint (tcp://host:port)')
    w.add_argument('--data-bind', default='tcp://127.0.0.1:*',
                   help='ROUTER endpoint to stream batches from; the address is advertised to '
                        'the dispatcher, so bind one the training hosts can reach')
    w.add_argument('--advertise-host', default=None,
                   help='host published to the dispatcher in place of the bind host (a '
                        'wildcard bind publishes the machine hostname)')
    w.add_argument('--max-inflight-splits', type=int, default=3)
    w.add_argument('--max-buffered-chunks', type=int, default=32)
    w.add_argument('--cache-plane-dir', default=None,
                   help="this worker's cache plane directory in place of the job's")

    s = sub.add_parser('status', help='print dispatcher stats as JSON')
    s.add_argument('--dispatcher', required=True)

    g = sub.add_parser('drain', help='gracefully drain one worker (scale-in): it finishes or '
                                     'hands back in-flight splits, then deregisters')
    g.add_argument('--dispatcher', required=True)
    g.add_argument('--worker', required=True, help="worker id from `status` (e.g. 'w0')")

    p = sub.add_parser('stop', help='ask the dispatcher to shut down')
    p.add_argument('--dispatcher', required=True)

    c = sub.add_parser('clock', help='measure clock offset and RTT to the dispatcher (the '
                                     'handshake that aligns spans across processes)')
    c.add_argument('--dispatcher', required=True)
    c.add_argument('--samples', type=int, default=5,
                   help='handshakes to run; the one with the least RTT wins')
    return parser


def _rpc_once(addr, request):
    import zmq

    from petastorm_tpu_torch.service.worker import _Rpc
    context = zmq.Context()
    rpc = _Rpc(context, addr)
    try:
        return rpc.call(request)
    finally:
        rpc.close()
        context.term()


def config_from_args(args):
    """The :class:`~petastorm_tpu_torch.service.config.ServiceConfig` of a
    parsed ``dispatcher`` command line."""
    from petastorm_tpu_torch.service.config import ServiceConfig
    reader_kwargs = {}
    if args.workers_count is not None:
        reader_kwargs['workers_count'] = args.workers_count
    return ServiceConfig(
        dataset_url=args.dataset_url,
        num_consumers=args.num_consumers,
        rowgroups_per_split=args.rowgroups_per_split,
        lease_ttl_s=args.lease_ttl_s,
        credits=args.credits,
        reader_factory=args.reader_factory,
        reader_kwargs=reader_kwargs,
        cache_plane=args.cache_plane_dir is not None,
        cache_plane_dir=args.cache_plane_dir,
        cache_plane_ram_bytes=args.cache_plane_ram_bytes,
        cache_plane_disk_bytes=args.cache_plane_disk_bytes,
        cluster_cache=(False if args.no_cluster_cache else None),
        ingest=args.ingest,
        telemetry_spans=not args.no_telemetry_spans,
        ledger_path=args.ledger_path,
        drain_timeout_s=args.drain_timeout_s,
        max_tenant_jobs=args.max_tenant_jobs,
        tenant_shm_quota_bytes=args.tenant_shm_quota_bytes,
        tenant_cache_quota_bytes=args.tenant_cache_quota_bytes,
        autoscale=args.autoscale,
        autoscale_min_workers=args.autoscale_min_workers,
        autoscale_max_workers=args.autoscale_max_workers,
        autoscale_step=args.autoscale_step,
        autoscale_cooldown_s=args.autoscale_cooldown_s,
        autoscale_starve_s=args.autoscale_starve_s,
        autoscale_idle_s=args.autoscale_idle_s)


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s %(name)s %(levelname)s %(message)s')
    args = _build_parser().parse_args(argv)

    if args.command == 'dispatcher':
        from petastorm_tpu_torch.service.dispatcher import Dispatcher
        with Dispatcher(config_from_args(args), bind=args.bind) as dispatcher:
            metrics_server = None
            if args.metrics_port is not None:
                from petastorm_tpu_torch.telemetry.scrape import start_metrics_server
                # through the stats handler, so the numbers of a scrape are
                # those of `status` at that moment
                metrics_server = start_metrics_server(
                    args.metrics_port, refresh=lambda: dispatcher._op_stats({}))
                print('metrics on http://0.0.0.0:%d/metrics' % metrics_server.server_address[1],
                      flush=True)
            print('dispatcher serving %s (%d splits, %d consumers)'
                  % (dispatcher.addr, dispatcher._job['num_splits'], args.num_consumers),
                  flush=True)
            try:
                while dispatcher._thread.is_alive():
                    time.sleep(0.5)
            except KeyboardInterrupt:
                pass
            finally:
                if metrics_server is not None:
                    metrics_server.shutdown()
                    metrics_server.server_close()
        return 0

    if args.command == 'worker':
        from petastorm_tpu_torch.service.worker import Worker
        worker = Worker(args.dispatcher, data_bind=args.data_bind,
                        advertise_host=args.advertise_host,
                        max_inflight_splits=args.max_inflight_splits,
                        max_buffered_chunks=args.max_buffered_chunks,
                        cache_plane_dir=args.cache_plane_dir)
        # SIGTERM drains: in-flight splits finish or go back, then the
        # worker deregisters
        worker.install_signal_handlers()
        try:
            worker.run()
        except KeyboardInterrupt:
            pass
        return 0

    if args.command == 'status':
        print(json.dumps(_rpc_once(args.dispatcher, {'op': 'stats'}), indent=1, sort_keys=True,
                         default=str))
        return 0

    if args.command == 'drain':
        from petastorm_tpu_torch.errors import ServiceError
        try:
            _rpc_once(args.dispatcher, {'op': 'drain', 'worker_id': args.worker})
        except ServiceError as e:
            print('drain refused: %s' % e, file=sys.stderr)
            return 1
        print('worker %s draining (watch `status` for it to deregister)' % args.worker)
        return 0

    if args.command == 'stop':
        _rpc_once(args.dispatcher, {'op': 'stop'})
        print('dispatcher at %s stopped' % args.dispatcher)
        return 0

    if args.command == 'clock':
        import zmq

        from petastorm_tpu_torch.service.worker import _Rpc
        from petastorm_tpu_torch.telemetry.spans import measure_clock_offset
        context = zmq.Context()
        rpc = _Rpc(context, args.dispatcher)
        try:
            samples = [measure_clock_offset(lambda: rpc.call({'op': 'clock'})['t_mono'])
                       for _ in range(max(1, args.samples))]
        finally:
            rpc.close()
            context.term()
        offset_s, rtt_s = min(samples, key=lambda s: s[1])
        print(json.dumps({'offset_s': offset_s, 'rtt_s': rtt_s, 'samples': len(samples)},
                         sort_keys=True))
        return 0

    return 2   # argparse enforces the command set


if __name__ == '__main__':
    sys.exit(main())
