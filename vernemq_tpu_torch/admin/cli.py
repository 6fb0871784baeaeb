"""``vmq-admin`` — operator CLI against a running broker.

The reference CLI (clique, ``vmq_server_cli.erl``) runs inside the target
node via distribution; here the CLI speaks to the broker's HTTP management
API (the same transport ``vmq_http_mgmt_api.erl`` exposes), so
``python -m vernemq_tpu_torch.admin session show`` works against any reachable
node. Tables are pretty-printed like clique's table writer; ``--json``
emits the raw API payload (the ``vmq_cli_json_writer`` switch).
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Dict, List


def format_table(rows: List[Dict[str, Any]]) -> str:
    if not rows:
        return "(no rows)"
    cols: List[str] = []
    for row in rows:
        for k in row:
            if k not in cols:
                cols.append(k)
    widths = {c: len(c) for c in cols}
    rendered = []
    for row in rows:
        r = {c: _cell(row.get(c)) for c in cols}
        for c in cols:
            widths[c] = max(widths[c], len(r[c]))
        rendered.append(r)
    sep = "+" + "+".join("-" * (widths[c] + 2) for c in cols) + "+"
    out = [sep, "|" + "|".join(f" {c.ljust(widths[c])} " for c in cols) + "|", sep]
    for r in rendered:
        out.append("|" + "|".join(f" {r[c].ljust(widths[c])} " for c in cols) + "|")
    out.append(sep)
    return "\n".join(out)


def _cell(v: Any) -> str:
    if v is None:
        return ""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def run_remote(base_url: str, api_key: str, words: List[str],
               timeout: float = 10.0) -> Dict[str, Any]:
    path_words, query = [], []
    for w in words:
        if "=" in w or w.startswith("--"):
            k, _, v = w.lstrip("-").partition("=")
            query.append((k, v))
        else:
            path_words.append(urllib.parse.quote(w, safe=""))
    if api_key:
        query.append(("api_key", api_key))
    url = (f"{base_url.rstrip('/')}/api/v1/" + "/".join(path_words)
           + ("?" + urllib.parse.urlencode(query) if query else ""))
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        try:
            return json.loads(e.read().decode())
        except Exception:
            return {"error": f"HTTP {e.code}"}
    except (urllib.error.URLError, OSError) as e:
        return {"error": f"cannot reach broker at {base_url}: {e}"}


def main(argv: List[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="vmq-admin",
        description="administer a running vernemq_tpu_torch broker",
        add_help=False)
    parser.add_argument("--node-url", default="http://127.0.0.1:8888",
                        help="broker HTTP endpoint (default %(default)s)")
    parser.add_argument("--api-key", default="",
                        help="management API key (api-key create)")
    parser.add_argument("--json", action="store_true",
                        help="emit raw JSON instead of tables")
    parser.add_argument("-h", "--help", action="store_true")
    args, words = parser.parse_known_args(argv)

    if args.help or not words:
        parser.print_help()
        print("\nExamples:\n"
              "  vmq-admin node status\n"
              "  vmq-admin session show --limit=10\n"
              "  vmq-admin metrics show\n"
              "  vmq-admin cluster join discovery-node=host:24053\n"
              "  vmq-admin api-key create\n")
        return 0

    result = run_remote(args.node_url, args.api_key, words)
    if args.json:
        print(json.dumps(result, indent=2, default=str))
        return 1 if "error" in result else 0
    if "error" in result:
        print(f"error: {result['error']}", file=sys.stderr)
        if result.get("usage"):
            print(result["usage"], file=sys.stderr)
        return 1
    if result.get("type") == "table":
        print(format_table(result.get("table", [])))
    else:
        print(result.get("text", ""))
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
