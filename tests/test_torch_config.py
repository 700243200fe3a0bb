"""The port's TOML config (pilosa_tpu_torch/config.py) and its
``generate-config`` and ``config`` commands against the reference's
(pilosa_tpu/config.py, pilosa_tpu/cmd.py:800-807): the same defaults,
precedence (defaults < TOML < environment < overrides), environment
coercion and handling of unknown keys, and byte-identical ``to_toml()``
output.  Every load passes ``env=`` or runs under ``monkeypatch``, so
that the host's ``PILOSA_TPU_*`` variables never reach a test.  Also
``config.UNAPPLIED``, the keys the port parses and does not apply yet,
and the log lines ``cmd.unapplied`` makes of them."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

from pilosa_tpu import cmd as jcmd
from pilosa_tpu.config import Config as JConfig
from pilosa_tpu_torch import cmd as tcmd
from pilosa_tpu_torch.config import UNAPPLIED
from pilosa_tpu_torch.config import Config as TConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: a file that sets every section, with two tenant quota tables
FULL = """\
data-dir = "/srv/pilosa"
bind = "10.0.0.5:10111"
name = "node-a"
verbose = true
log-path = "/var/log/pilosa.log"
max-writes-per-request = 77
max-wal-files = 64
heartbeat-interval = 1.5

[cluster]
replicas = 3
partitions = 128
seeds = ["http://a:10101", "http://b:10101"]
coordinator = true
long-query-time = 0.25
breaker-threshold = 7
breaker-cooldown = 2.5
hedge-min-samples = 4
hedge-deviations = 3.0
hedge-min-ms = 11.0
hedge-max-fraction = 0.2

[anti-entropy]
interval = 60.0
jitter = 0.2
round-budget = 5.0
peer-timeout = 1.0

[replication]
write-policy = "available"
hint-max-bytes = 1024
hint-max-age = 10.0
replay-interval = 0.25

[rebalance]
transfer-budget = 4
dual-write-policy = "strict"
cursor-path = "/tmp/cursor"
backoff-base = 0.1
backoff-cap = 3.0
peer-timeout = 4.0

[metric]
service = "statsd"
host = "127.0.0.1:9125"
poll-interval = 10.0
diagnostics = true

[tracing]
enabled = true
endpoint = "http://collector:4318"

[profile]
heap = true
heap-frames = 8

[coalescer]
enabled = "true"
window-ms = 4.5
max-batch = 16

[ragged]
enabled = false
max-tape = 64
max-leaves = 8
prewarm = false

[vm]
enabled = false
min-domain = 16
max-prefetch = 4096

[observe]
enabled = false
recent = 32
long-query-time = 0.5
device-sample-interval = 2.0
fanin-timeout = 1.0
device-peak-gbps = 3350.0
profiler-max-seconds = 5.0
journal = false
journal-size = 64
journal-kinds = "node,shard"

[cost]
shadow = false

[admission]
enabled = false
query-cap = 8
query-queue = 9
ingest-cap = 10
ingest-queue = 11
internal-cap = 12
internal-queue = 13
default-deadline = 2.5

[cache]
enabled = false
budget-bytes = 1048576
max-entry-bytes = 4096
ttl = 30.0

[ingest]
delta-enabled = false
delta-budget-bytes = 2048
compact-threshold-bits = 512
compact-interval = 0.5

[containers]
enabled = false
threshold = 0.5
kinds = false
array-max = 2048
run-cap = 64

[mesh]
enabled = "false"
axis-size = 2

[residency]
host-budget-bytes = 0
disk-path = "/tmp/spill"
disk-budget-bytes = 1024
promote-workers = 1
promote-queue = 8
promote-wait-ms = 5.0
prefetch = false
prefetch-interval = 1.0

[faultinject]
armed = "client.request.send=error(transport)*3"

[tenants]
enabled = true
default-share = 2
default-queue = 3
default-cache-share = 0.125
default-residency-share = 0.75

[tenants.quotas."gold"]
share = 16
queue = 64
cache-share = 0.5

[tenants.quotas."free"]
share = 2
queue = 8

[tls]
certificate-path = "/etc/cert.pem"
key-path = "/etc/key.pem"
skip-verify = true
"""

#: one environment override per coerced type
ENV = {
    "PILOSA_TPU_VERBOSE": "yes",
    "PILOSA_TPU_BIND": "0.0.0.0:9999",
    "PILOSA_TPU_MAX_WRITES_PER_REQUEST": "12",
    "PILOSA_TPU_CLUSTER_REPLICAS": "2",
    "PILOSA_TPU_CLUSTER_LONG_QUERY_TIME": "0.125",
    "PILOSA_TPU_CLUSTER_SEEDS": "http://x:1,,http://y:2",
    "PILOSA_TPU_CACHE_ENABLED": "off",
    "PILOSA_TPU_CACHE_TTL": "1.5",
    "PILOSA_TPU_ADMISSION_QUERY_CAP": "5",
    "PILOSA_TPU_COALESCER_ENABLED": "false",
    "PILOSA_TPU_MESH_ENABLED": "false",
    "PILOSA_TPU_TENANTS_QUOTAS": "gold:16:64:0.5,free:2:8",
}


@pytest.fixture
def full_file(tmp_path):
    p = tmp_path / "full.toml"
    p.write_text(FULL)
    return str(p)


def test_the_defaults_render_the_same_bytes():
    want = JConfig().to_toml()
    assert TConfig().to_toml() == want
    assert TConfig.load(env={}).to_toml() == want


@pytest.mark.parametrize("case", ["defaults", "full", "env", "full+env"])
def test_to_toml_is_byte_identical(full_file, case):
    path = full_file if "full" in case else None
    env = ENV if "env" in case else {}
    want = JConfig.load(path, env=env).to_toml()
    got = TConfig.load(path, env=env).to_toml()
    assert got == want
    if case == "full":
        assert '[tenants.quotas."gold"]' in got
        assert '[tenants.quotas."free"]' in got


def test_precedence_is_defaults_toml_env_overrides(full_file):
    for C in (JConfig, TConfig):
        cfg = C.load(full_file, env={})
        assert (cfg.bind, cfg.cluster.replicas, cfg.admission.query_cap,
                cfg.cache.enabled) == ("10.0.0.5:10111", 3, 8, False)
        cfg = C.load(full_file, env={"PILOSA_TPU_BIND": "h:1",
                                     "PILOSA_TPU_CLUSTER_REPLICAS": "5"})
        assert (cfg.bind, cfg.cluster.replicas, cfg.admission.query_cap) \
            == ("h:1", 5, 8)
        cfg = C.load(full_file, env={"PILOSA_TPU_BIND": "h:1"},
                     overrides={"bind": "o:2", "cluster": {"replicas": 6},
                                "max-writes-per-request": 0})
        assert (cfg.bind, cfg.cluster.replicas, cfg.max_writes_per_request,
                cfg.host, cfg.port) == ("o:2", 6, 0, "o", 2)
        assert C.load(env={}).max_writes_per_request == 5000


@pytest.mark.parametrize("key,raw,want", [
    ("PILOSA_TPU_VERBOSE", "on", ("verbose", True)),
    ("PILOSA_TPU_VERBOSE", "0", ("verbose", False)),
    ("PILOSA_TPU_MAX_WAL_FILES", "9", ("max_wal_files", 9)),
    ("PILOSA_TPU_CACHE_TTL", "2.25", ("cache.ttl", 2.25)),
    ("PILOSA_TPU_CLUSTER_SEEDS", "a,,b", ("cluster.seeds", ["a", "b"])),
    ("PILOSA_TPU_TENANTS_QUOTAS", "gold:16:64:0.5,free:2",
     ("tenants.quotas", {
         "gold": {"share": 16, "queue": 64, "cache_share": 0.5,
                  "residency_share": 0.5},
         "free": {"share": 2, "queue": 16, "cache_share": 0.25,
                  "residency_share": 0.5}})),
])
def test_environment_coercion(key, raw, want):
    path, value = want
    for C in (JConfig, TConfig):
        cfg = C.load(env={key: raw})
        obj = cfg
        for part in path.split("."):
            obj = getattr(obj, part)
        assert obj == value
    assert (TConfig.load(env={key: raw}).to_toml()
            == JConfig.load(env={key: raw}).to_toml())


def test_unknown_keys_are_ignored_the_same_way(tmp_path):
    p = tmp_path / "unknown.toml"
    p.write_text('nonsense = 1\nbind = "h:5"\n\n[cluster]\nreplicas = 2\n'
                 'bogus = "x"\n\n[nosuchsection]\nk = 1\n\n'
                 '[cache]\nwhat = true\n')
    env = {"PILOSA_TPU_NOPE": "1", "PILOSA_TPU_CACHE_NOPE": "2"}
    want = JConfig.load(str(p), env=env).to_toml()
    assert TConfig.load(str(p), env=env).to_toml() == want
    assert 'bind = "h:5"' in want and "replicas = 2" in want


def _printed(capsys, main, argv) -> tuple[int, str]:
    rc = main(argv)
    return rc, capsys.readouterr().out


def _clear_env(monkeypatch) -> None:
    for k in list(os.environ):
        if k.startswith("PILOSA_TPU_") and k != "PILOSA_TPU_SHARD_WIDTH_EXP":
            monkeypatch.delenv(k)


@pytest.mark.parametrize("case", ["generate", "defaults", "full", "env"])
def test_generate_config_and_config_print_the_same_bytes(
        capsys, monkeypatch, full_file, case):
    _clear_env(monkeypatch)
    if case == "generate":
        argv = ["generate-config"]
    else:
        argv = ["config"] + (["-c", full_file] if case == "full" else [])
    if case == "env":
        for k, v in ENV.items():
            monkeypatch.setenv(k, v)
        argv += ["-c", full_file]
    want = _printed(capsys, jcmd.main, argv)
    assert _printed(capsys, tcmd.main, argv) == want
    assert want[0] == 0 and want[1].startswith('data-dir = "')


def test_the_entry_point_prints_the_reference_config(full_file):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PILOSA_TPU_")
           or k == "PILOSA_TPU_SHARD_WIDTH_EXP"}
    env["PYTHONPATH"] = ROOT
    env["PILOSA_TPU_CLUSTER_REPLICAS"] = "4"
    res = subprocess.run(
        [sys.executable, "-m", "pilosa_tpu_torch", "config", "-c",
         full_file], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout == JConfig.load(
        full_file, env={"PILOSA_TPU_CLUSTER_REPLICAS": "4"}).to_toml()


def test_unapplied_names_existing_keys_with_their_queue_items():
    cfg = TConfig()
    for (section, name), item in UNAPPLIED.items():
        assert item in ("5a", "7", "8", "10", "11")
        obj = cfg if section is None else getattr(cfg, section)
        assert name == "*" or hasattr(obj, name), (section, name)
    # [residency] and [ragged] prewarm are applied since item 8's first
    # half; its [faultinject] is not yet
    assert not [k for k in UNAPPLIED
                if k[0] == "residency" or k == ("ragged", "prewarm")]
    assert UNAPPLIED[("faultinject", "*")] == "8"
    # nothing at its default is reported
    assert tcmd.unapplied(TConfig()) == []


def test_unapplied_reports_each_changed_key_the_port_does_not_apply(
        full_file):
    got = {key: (value, item)
           for key, value, item in tcmd.unapplied(
               TConfig.load(full_file, env={}))}
    assert got["max-wal-files"] == (64, "5a")
    assert got["heartbeat-interval"] == (1.5, "10")
    assert got["name"] == ("node-a", "10")
    assert got["[cluster] replicas"] == (3, "10")
    assert got["[mesh] enabled"] == ("false", "11")
    assert got["[observe] long-query-time"] == (0.5, "7")
    assert got["[faultinject] armed"] == (
        "client.request.send=error(transport)*3", "8")
    assert got["[tls] skip-verify"] == (True, "10")
    # applied keys are never reported
    for key in ("[cluster] long-query-time", "max-writes-per-request",
                "[cache] enabled", "[admission] query-cap",
                "[containers] threshold", "[tenants] default-share",
                "[tenants] default-residency-share", "verbose", "bind",
                "[residency] host-budget-bytes", "[residency] prefetch",
                "[ragged] prewarm"):
        assert key not in got
    assert not any(k.startswith("[residency]") for k in got)
