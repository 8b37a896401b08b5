"""The one generator of every traffic mix: a mix file of parameters
(`traffic/<mix>.json`) and a seed in, the mix's requests out.

The sizes of a mix (prompt words, new tokens, questions, arrival gaps) are
its distributions' quantiles: every `block` consecutive requests hold the
same multiset of sizes. The run's seed draws their pairing and order within
each block, the words and the images (and the weights). So every seed
offers the same work block by block, in an order of its own, and a window
that spans whole blocks (the closed chat loop's) admits the same work in
every run.

Prompts are made of words from a fixed vocabulary whose words fall into
distinct buckets of the hash-bucket tokenizer the served model uses
(`word_id`), so the benchmark knows each prompt's token ids without asking
the program. This module imports neither torch nor the program: the load
generator, a process of its own, uses it too.
"""

from __future__ import annotations

import hashlib
import io
import json
import math
from pathlib import Path
from typing import Dict, List

import numpy as np

ROOT = Path(__file__).resolve().parent
BASE_VOCAB = 32000          # the hash-bucket tokenizer's base vocabulary
VOCAB_WORDS = 4096


def load_mix(name: str) -> dict:
    """The mix `traffic/<name>.json`, or the file `name` when it is a path
    to a .json file (the tests' small mixes)."""
    path = Path(name) if name.endswith(".json") else \
        ROOT / "traffic" / f"{name}.json"
    with open(path) as f:
        mix = json.load(f)
    mix["name"] = name
    return mix


def word_id(word: str, base_vocab: int = BASE_VOCAB) -> int:
    """The hash-bucket id of one whitespace-free word: 3 + md5 mod
    (base_vocab - 3)."""
    h = int(hashlib.md5(word.encode()).hexdigest(), 16)
    return 3 + h % (base_vocab - 3)


def vocabulary(n: int = VOCAB_WORDS, base_vocab: int = BASE_VOCAB
               ) -> List[str]:
    """n words whose ids are pairwise distinct."""
    words, seen, j = [], set(), 0
    while len(words) < n:
        w = f"w{j}"
        j += 1
        i = word_id(w, base_vocab)
        if i not in seen:
            seen.add(i)
            words.append(w)
    return words


def _quantile_sizes(spec: dict, n: int) -> np.ndarray:
    """n sizes spread over the distribution by its quantiles (so the
    multiset is the same whatever orders it), clipped to [min, max]. A
    lognormal is given by its sigma and its median, or its mean (the
    median is then mean * exp(-sigma^2 / 2))."""
    u = (np.arange(n) + 0.5) / n
    lo, hi = spec["min"], spec["max"]
    if spec["dist"] == "lognormal":
        from statistics import NormalDist
        z = np.array([NormalDist().inv_cdf(float(x)) for x in u])
        median = spec["median"] if "median" in spec else \
            spec["mean"] * math.exp(-spec["sigma"] ** 2 / 2)
        v = median * np.exp(spec["sigma"] * z)
    elif spec["dist"] == "uniform":
        v = lo + u * (hi - lo + 1) - 0.5
    else:
        raise ValueError(f"unknown size distribution {spec['dist']!r}")
    return np.clip(np.round(v), lo, hi).astype(np.int64)


def requests(mix: dict, seed: int) -> List[Dict]:
    """The mix's request sequence for `seed`: each {"i", "words", "new",
    "image" (None or an image seed), "due" (open loop: seconds after the
    load's start)}. Every `block` consecutive requests hold the same
    multiset of prompt sizes, of new-token budgets and of arrival gaps;
    `seed` draws how they pair and their order within each block, and the
    words and images."""
    n, blk = int(mix["requests"]), int(mix.get("block", mix["requests"]))
    prompt = _quantile_sizes(mix["prompt_words"], blk)
    new = _quantile_sizes(mix["new_tokens"], blk)
    gaps = None
    if mix["loop"] == "open":
        # Poisson arrivals: exponential gaps by their quantiles
        u = (np.arange(blk) + 0.5) / blk
        gaps = -np.log1p(-u) / float(mix["rate"])
    rng = np.random.default_rng([int(seed) & (2 ** 63 - 1), 0x7EA])
    order = np.random.default_rng([int(seed) & (2 ** 63 - 1), 0x0D5])
    vocab = vocabulary()
    out, t = [], 0.0
    for i in range(n):
        if i % blk == 0:
            p_order, n_order = order.permutation(blk), order.permutation(blk)
            gap_order = order.permutation(blk)
        j = i % blk
        words = [vocab[k] for k in rng.integers(0, len(vocab),
                                                int(prompt[p_order[j]]))]
        req = {"i": i, "words": words, "new": int(new[n_order[j]]),
               "image": None, "due": None}
        if mix.get("images", 0):
            req["image"] = int(rng.integers(0, 2 ** 62))
        if gaps is not None:
            t += float(gaps[gap_order[j]])
            req["due"] = t
        out.append(req)
    return out


def words_of(text: str) -> List[str]:
    """The whitespace-separated pieces of a text."""
    import re
    return re.findall(r"\S+", text)


def pieces(text: str, specials: Dict[str, int]) -> List:
    """A text as the hash-bucket tokenizer reads it: the special strings
    (longest first) as themselves, every other stretch split into its
    whitespace-separated pieces."""
    import re
    pat = re.compile("(" + "|".join(re.escape(k) for k in sorted(
        specials, key=len, reverse=True)) + ")")
    out: List[str] = []
    for part in pat.split(text):
        if part in specials:
            out.append(part)
        elif part:
            out.extend(words_of(part))
    return out


def hash_tokens(text: str, specials: Dict[str, int],
                base_vocab: int = BASE_VOCAB) -> List[int]:
    """A text's ids under the hash-bucket tokenizer: the special strings
    are their ids, every other piece its bucket."""
    return [specials[p] if p in specials else word_id(p, base_vocab)
            for p in pieces(text, specials)]


def prompt_ids(req: dict, image_ids: List[int] = (), bos: int = 1
               ) -> List[int]:
    """The served prompt's token ids: BOS, the image's placeholder ids
    (when it has one), then one id a word."""
    return [bos, *(image_ids if req["image"] is not None else ()),
            *(word_id(w) for w in req["words"])]


def image(seed: int, width: int, height: int) -> np.ndarray:
    """A seeded RGB image [height, width, 3] uint8: a smooth random field
    (a coarse grid of colours, bilinearly upsampled by PIL) with fine
    noise, so it compresses as a photograph does rather than as white
    noise; about 10 ms at 640 x 480."""
    from PIL import Image
    rng = np.random.default_rng([int(seed), 0x1A6E])
    gh, gw = max(2, height // 40), max(2, width // 40)
    coarse = rng.integers(0, 256, (gh, gw, 3), dtype=np.uint8)
    field = np.asarray(Image.fromarray(coarse).resize((width, height),
                                                      Image.BILINEAR))
    noise = rng.integers(-8, 9, field.shape, dtype=np.int16)
    return np.clip(field.astype(np.int16) + noise, 0, 255).astype(np.uint8)


def png(arr: np.ndarray) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return buf.getvalue()


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by the nearest-rank rule."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of nothing")
    k = max(0, math.ceil(q / 100 * len(v)) - 1)
    return float(v[k])
