"""The port's copies of the reference's host modules stay verbatim: each
copied module equals the reference's source after the listed changes,
which are the port's names (logger names, module paths in docstrings and
launcher hints), a few comment lines reworded (``LINES``) and the
departures ROADMAP lists, each marked where it is replaced."""

import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _loggers(*names):
    return [(f'getLogger("vernemq_tpu.{n}")',
             f'getLogger("vernemq_tpu_torch.{n}")') for n in names]


#: module (relative to either package) -> the (reference, port) string
#: replacements that turn the reference's source into the port's
COPIES = {
    "admin/__init__.py": [],
    "admin/__main__.py": [],
    "admin/churney.py": [],
    "admin/cli.py": [
        ("python -m vernemq_tpu.admin", "python -m vernemq_tpu_torch.admin"),
        ("a running vernemq_tpu broker", "a running vernemq_tpu_torch broker"),
    ],
    "admin/commands.py": _loggers("cluster", "handoff", "admin") + [
        ("service launcher (python -m vernemq_tpu ...)",
         "service launcher (python -m vernemq_tpu_torch.broker.server ...)"),
    ],
    "admin/graphite.py": _loggers("graphite"),
    "admin/http.py": _loggers("http"),
    "admin/ql.py": [
        ("(vernemq_tpu/retained/)", "(vernemq_tpu_torch/retained/)"),
        ("(vernemq_tpu/filters/)", "(vernemq_tpu_torch/filters/)"),
    ],
    "admin/tracer.py": [],
    "broker/listeners.py": _loggers("listeners"),
    "cluster/mesh_map.py": _loggers("mesh") + [
        ("~vernemq_tpu.cluster.metadata", "~vernemq_tpu_torch.cluster.metadata"),
        ("``MeshTpuMatcher.adopt_slices``", "``MeshGpuMatcher.adopt_slices``"),
    ],
    "cluster/swc_db.py": [],
    "cluster/swc_kernel.py": [],
    "cluster/swc_store.py": _loggers("swc") + [
        # a departure (ROADMAP "Departures"): the exchange on a new
        # channel ends a join's bulk load, where the broker's
        # full-collection policy (broker/heap.py) runs
        ("from . import swc_kernel as K\n",
         "from . import swc_kernel as K\nfrom .com import joined\n"),
        ("                          exc_info=t.exception())\n",
         "                          exc_info=t.exception())\n"
         "            elif not t.cancelled():\n"
         "                # the exchange on a new channel is a join's bulk "
         "load: the\n"
         "                # broker's full-collection policy runs after it\n"
         "                joined(peer, t.result())\n"),
    ],
    "native/bcrypt.py": [],
    "plugins/__init__.py": _loggers("plugins"),
    "plugins/acl.py": _loggers("acl"),
    "plugins/bridge.py": _loggers("bridge") + [
        ("``vernemq_tpu.client.ReconnectingClient``",
         "``vernemq_tpu_torch.client.ReconnectingClient``"),
        (":class:`~vernemq_tpu.client.ReconnectingClient`",
         ":class:`~vernemq_tpu_torch.client.ReconnectingClient`"),
        # a departure (ROADMAP "Departures"): under the GPU view a bridged
        # publish is matched on the card, not on the host trie
        ("                self.broker.registry.publish(msg, "
         "from_sid=self.sid)\n",
         "                reg = self.broker.registry\n"
         "                if reg.batched_view_active():\n"
         "                    # matched on the card in arrival order, as a\n"
         "                    # session's publish is, not on the host trie\n"
         "                    reg.publish_nowait(msg, from_sid=self.sid)\n"
         "                else:\n"
         "                    reg.publish(msg, from_sid=self.sid)\n"),
    ],
    "plugins/connectors.py": [],
    "plugins/lua/auth_commons.lua": [
        ("(vernemq_tpu edition)", "(vernemq_tpu_torch edition)"),
    ],
    "plugins/lua_bridge.py": _loggers("lua") + [
        ('getLogger(f"vernemq_tpu.lua.', 'getLogger(f"vernemq_tpu_torch.lua.'),
        (":class:`~vernemq_tpu.plugins.scripting.ScriptingPlugin`",
         ":class:`~vernemq_tpu_torch.plugins.scripting.ScriptingPlugin`"),
    ],
    "plugins/mqtt5_demo.py": [],
    "plugins/passwd.py": _loggers("passwd"),
    "plugins/scripting.py": _loggers("scripting") + [
        ('getLogger(f"vernemq_tpu.script.',
         'getLogger(f"vernemq_tpu_torch.script.'),
    ],
    "plugins/webhooks.py": _loggers("webhooks"),
    "utils/__init__.py": [],
    "utils/lua.py": [],
}

#: module -> {line number (1-based): the port's line} for comment lines
#: the port words differently
LINES = {
    "admin/churney.py": {
        7: "sessions back-to-back and logs a histogram every 10s; here the "
           "loop is"},
    "admin/commands.py": {
        1613: "    accounting, the compaction loop's counters + breaker, and "
              "the",
        1645: "    maintenance pass off the loop (the periodic loop's tick "
              "body).\"\"\""},
    "cluster/swc_store.py": {
        16: "  plus the anti-entropy exchange loop ⇢ "
            "``vmq_swc_exchange_fsm.erl``:"},
}


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_copied_module_equals_the_reference(rel):
    ref = (ROOT / "vernemq_tpu" / rel).read_text()
    port = (ROOT / "vernemq_tpu_torch" / rel).read_text()
    for a, b in COPIES[rel]:
        assert ref.count(a) >= 1, f"{rel}: {a!r} is no longer in the reference"
        ref = ref.replace(a, b)
    lines = ref.split("\n")
    for n, line in LINES.get(rel, {}).items():
        lines[n - 1] = line
    assert port == "\n".join(lines), \
        f"{rel} departs from the reference beyond its renames"
