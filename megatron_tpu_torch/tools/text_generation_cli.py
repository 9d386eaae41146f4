"""Interactive client of the text-generation server (the port of the root
tools/text_generation_cli.py, standard library only): reads a prompt and a
token count from stdin, PUTs them to <host:port>/api and prints the text.

  python -m megatron_tpu_torch.tools.text_generation_cli 127.0.0.1:5000
"""
from __future__ import annotations

import json
import sys
import urllib.error
import urllib.request


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: text_generation_cli <host:port>")
        return 1
    url = f"http://{argv[0]}/api"
    while True:
        try:
            prompt = input("Enter prompt: ")
        except EOFError:
            return 0
        n = input("Enter number of tokens to generate: ")
        payload = json.dumps({"prompts": [prompt],
                              "tokens_to_generate": int(n)}).encode()
        req = urllib.request.Request(
            url, data=payload, method="PUT",
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req) as resp:
                data = json.loads(resp.read())
        except urllib.error.HTTPError as e:
            # the server answers real statuses (400, 429, 500) with a JSON
            # message: print it and go on
            try:
                msg = json.loads(e.read()).get("message", str(e))
            except Exception:
                msg = str(e)
            print(f"Server error ({e.code}): {msg}")
            continue
        print("Megatron Response:")
        print(data["text"][0])


if __name__ == "__main__":
    sys.exit(main())
