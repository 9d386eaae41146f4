"""Filter a URL list against domain/extension blacklists.

The port's copy of the root tools/openwebtext/blacklist_urls.py.

Counterpart of ref: tools/openwebtext/blacklist_urls.py — same contract
(input: files of one URL per line, output: the clean URLs), same filter
axes: blacklisted registered domains (media/social/commerce hosts whose
pages are not prose), blacklisted path extensions (binary/media files),
malformed or overlong URLs. The domain list ships as a starter set and
extends via --domain_blacklist_file (the reference hardcodes ~200 domains;
the mechanism, not the list, is the tool).

Usage: python -m megatron_tpu_torch.tools.openwebtext.blacklist_urls
    <url_file_or_dir> <clean_urls_out>
"""
from __future__ import annotations

import glob
import os
import sys

from megatron_tpu_torch.tools.openwebtext.owt_utils import (
    registered_domain, url_extension)

DOMAIN_BLACKLIST = frozenset((
    # media/image/video hosts
    "imgur", "giphy", "gfycat", "flickr", "youtube", "youtu", "vimeo",
    "dailymotion", "liveleak", "imageshack", "imgflip", "gyazo",
    "deviantart", "artstation", "bandcamp", "soundcloud", "spotify",
    # social / chat
    "facebook", "fbcdn", "instagram", "twitter", "discord", "discordapp",
    "reddit", "redd", "snapchat", "pinterest", "tumblr",
    # commerce / apps
    "amazon", "ebay", "etsy", "apple", "google", "play", "steampowered",
    "twitch", "patreon", "paypal", "kickstarter",
    # infra / shorteners / misc non-prose
    "github", "dropbox", "akamaihd", "cloudfront", "bit", "goo", "tinyurl",
    "lmgtfy", "archive", "webcache", "wikimedia", "wiktionary",
))

EXTENSION_BLACKLIST = frozenset((
    "jpg", "jpeg", "png", "gif", "bmp", "webp", "svg", "ico", "tif",
    "mp3", "wav", "ogg", "flac", "mp4", "avi", "mkv", "webm", "mov",
    "pdf", "zip", "rar", "gz", "tar", "7z", "exe", "apk", "dmg", "iso",
    "css", "js", "xml", "rss", "atom",
))

MAX_URL_LEN = 500


def url_ok(url: str, domain_blacklist=DOMAIN_BLACKLIST,
           extension_blacklist=EXTENSION_BLACKLIST) -> bool:
    url = url.strip()
    if not url or len(url) > MAX_URL_LEN or " " in url:
        return False
    if not (url.startswith("http://") or url.startswith("https://")):
        return False
    if registered_domain(url) in domain_blacklist:
        return False
    if url_extension(url) in extension_blacklist:
        return False
    return True


def filter_urls(input_path: str, output_path: str,
                domain_blacklist_file: str | None = None) -> tuple:
    """Returns (kept, dropped)."""
    domains = set(DOMAIN_BLACKLIST)
    if domain_blacklist_file:
        with open(domain_blacklist_file) as f:
            domains.update(line.strip().lower() for line in f
                           if line.strip())
    paths = (sorted(glob.glob(os.path.join(input_path, "*")))
             if os.path.isdir(input_path) else [input_path])
    kept = dropped = 0
    with open(output_path, "w") as out:
        for path in paths:
            with open(path, errors="ignore") as f:
                for line in f:
                    url = line.strip()
                    if url_ok(url, domains):
                        out.write(url + "\n")
                        kept += 1
                    elif url:
                        dropped += 1
    return kept, dropped


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    assert len(argv) >= 2, __doc__
    kept, dropped = filter_urls(argv[0], argv[1],
                                argv[2] if len(argv) > 2 else None)
    print(f"blacklist_urls: kept {kept}, dropped {dropped}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
