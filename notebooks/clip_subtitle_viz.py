# %% [markdown]
# # CLIP ↔ subtitle visualization
#
# JAX analogue of the reference analysis notebook
# (`notebooks/clip_subtitle_viz.ipynb`): score every frame of a video against
# text spans mined from its ASR subtitles, and plot the per-frame similarity
# curve with keyframe thumbnails pinned along it.
#
# Differences from the reference, by design:
# - decord → `fitclip_tpu.data.video_reader` (native FFmpeg ext / OpenCV);
#   thumbnails come from a uniform time stride instead of codec key indices
#   (the reader protocol is codec-agnostic).
# - torch CLIP → the in-tree jax `ClipVideoTextEncoder`; frames are encoded
#   as 1-frame clips so one jitted `encode_video` call yields per-frame
#   embeddings on the accelerator.
# - spaCy sentence/chunk/phrase extraction → the POS-lite token-pattern
#   matcher the demo ships (`demo/search.py`); DEP-parse-grade splits are
#   approximated with POS patterns (documented per function).
#
# The file is a percent-format notebook: every `# %%` block is a cell.
# `scripts/py_to_ipynb.py` renders the committed `.ipynb` from it, and
# `tests/test_notebook.py` runs the core pipeline headless on a synthetic
# video + caption.

# %%
import json
import os
import re
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence

import matplotlib
import numpy as np

if not os.environ.get("DISPLAY"):
    matplotlib.use("Agg")

from matplotlib import pyplot as plt
from matplotlib.backends.backend_pdf import PdfPages
from matplotlib.offsetbox import AnnotationBbox, OffsetImage

from demo.search import _plausible_pos, load_caption
from fitclip_tpu.data.transforms import eval_transform
from fitclip_tpu.data.video_reader import VideoReader

# %% [markdown]
# ## Video loading
#
# Mirrors the reference's `get_video_info` (reference notebook cell 1): dense
# frames every `frame_stride` indices for the similarity curve, plus small
# thumbnails on a coarse time grid for the figure strip.

# %%
def get_video_info(path: str, frame_stride: int = 10,
                   thumbnail_interval_s: float = 2.0,
                   thumbnail_size: int = 64) -> Dict[str, Any]:
    reader = VideoReader.from_path(path)
    fps = reader.get_avg_fps()
    num_frames = len(reader)

    frame_indices = list(range(0, num_frames, frame_stride))
    frames = reader(frame_indices)

    thumb_stride = max(int(round(thumbnail_interval_s * fps)), 1)
    thumb_indices = list(range(0, num_frames, thumb_stride))
    thumbs = reader(thumb_indices)
    scale = thumbnail_size / max(thumbs.shape[1], thumbs.shape[2])
    import cv2
    thumbnails = [cv2.resize(t, None, fx=scale, fy=scale,
                             interpolation=cv2.INTER_AREA) for t in thumbs]

    return {
        "video_id": os.path.basename(path).rsplit(".", maxsplit=1)[0],
        "frames": list(frames),
        "frame_times": np.asarray(frame_indices, np.float64) / fps,
        "thumbnails": thumbnails,
        "thumbnail_times": np.asarray(thumb_indices, np.float64) / fps,
    }

# %% [markdown]
# ## Encoding
#
# Frames become 1-frame clips: `(N, 1, H, W, C)` through the encoder's
# jitted `encode_video` is N L2-normalized frame embeddings from one
# matmul chain (mean-pool over a single frame is the identity).

# %%
def encode_visual(frames: Sequence[np.ndarray], encoder,
                  batch_size: int = 64) -> np.ndarray:
    import jax

    spec = encoder.preprocess
    pixels = np.stack([eval_transform(f[None], spec.image_size,
                                      spec.resize_mode)[0] for f in frames])
    encode = jax.jit(encoder.encoder.encode_video)
    chunks = []
    for start in range(0, len(pixels), batch_size):
        clip_batch = pixels[start:start + batch_size, None]  # (b, 1, H, W, C)
        chunks.append(np.asarray(encode(encoder.params, clip_batch)))
    return np.concatenate(chunks)


def encode_text(texts: Sequence[str], encoder) -> np.ndarray:
    import jax

    tokens = encoder.get_tokenizer()(list(texts))
    return np.asarray(jax.jit(encoder.encoder.encode_text)(encoder.params,
                                                           tokens))

# %% [markdown]
# ## Figures
#
# One curve per text: frame-vs-text scores over time, thumbnails pinned at
# their timestamps. `mode` reproduces the reference's "alternatives to
# softmax" section (cells 9–16): temperature-softmax over frames, raw dot
# product, or unnormalized exponential.

# %%
def frame_text_scores(encoded_frames: np.ndarray, encoded_text: np.ndarray,
                      mode: str = "softmax",
                      temperature: float = 100.0) -> np.ndarray:
    dots = encoded_frames @ encoded_text.reshape(-1)
    if mode == "dot":
        return dots
    scaled = temperature * dots
    if mode == "exp":
        return np.exp(scaled - scaled.max())
    if mode == "softmax":
        exps = np.exp(scaled - scaled.max())
        return exps / exps.sum()
    raise ValueError(f"Unknown score mode: {mode}")


def create_figure(times: Sequence[float], probs: np.ndarray,
                  thumbnail_times: Sequence[float],
                  thumbnails: Sequence[np.ndarray], text: str) -> plt.Figure:
    fig, ax = plt.subplots(figsize=(12, 4))
    ax.plot(times, probs)
    ax.set_xlabel("time (s)")
    ax.set_ylabel("score")
    ax.set_title(text)

    curve_top = float(np.max(probs))
    for thumb_time, thumbnail in zip(thumbnail_times, thumbnails):
        box = AnnotationBbox(OffsetImage(thumbnail), (thumb_time, curve_top),
                             xybox=(0.0, 24.0), xycoords="data",
                             boxcoords="offset points", frameon=False)
        ax.add_artist(box)
    fig.tight_layout()
    return fig


def create_figure_for_text(encoded_frames: np.ndarray, text: str, encoder,
                           times: Sequence[float],
                           thumbnail_times: Sequence[float],
                           thumbnails: Sequence[np.ndarray],
                           mode: str = "softmax",
                           temperature: float = 100.0) -> plt.Figure:
    encoded_text = encode_text([text], encoder)[0]
    probs = frame_text_scores(encoded_frames, encoded_text, mode=mode,
                              temperature=temperature)
    return create_figure(times, probs, thumbnail_times, thumbnails, text)

# %% [markdown]
# ## Mining text spans from captions
#
# The reference mines four span families with a transformer parse (notebook
# cell 22). POS-lite equivalents, over the Google-STT word stream that
# `demo.search.load_caption` returns:
#
# - `get_sents`: split on transcript punctuation, mapped back to word times
#   by position.
# - `get_noun_chunks`: `DET? ADJ* (NOUN|PROPN)+` runs → "A photo of {chunk}."
# - `get_verb_phrases`: a VERB-candidate anchor plus its trailing tokens up
#   to the next anchor (subtree → right-neighborhood approximation).
# - `get_orders`: imperative heuristic — a sentence that starts with a
#   base-form verb candidate (excluding the reference's know/let/try
#   stop-list) and doesn't end in "?".

# %%
_SENT_RE = re.compile(r"[^.!?]+[.!?]*")  # keep the boundary punctuation
_ORDER_STOPLIST = {"know", "let", "try"}


def _span(caption: Mapping[str, Any], start: int, end: int,
          text: Optional[str] = None) -> Dict[str, Any]:
    tokens = caption["tokens_info"][start:end]
    return {
        "video_id": caption["video_id"],
        "start_time": tokens[0]["start_time"],
        "end_time": tokens[-1]["end_time"],
        "text": text if text is not None
        else " ".join(t["word"] for t in tokens),
    }


def get_sents(caption: Mapping[str, Any]) -> Iterator[Dict[str, Any]]:
    sentences = [m.group(0).strip() for m in _SENT_RE.finditer(caption["text"])
                 if m.group(0).strip()]
    position = 0
    total = len(caption["tokens_info"])
    for sentence in sentences:
        length = len(sentence.split())
        end = min(position + length, total)
        if end > position:
            yield _span(caption, position, end, text=sentence)
        position = end


def _word_pos(caption: Mapping[str, Any], index: int):
    return _plausible_pos(caption["tokens_info"][index]["word"])


def get_noun_chunks(caption: Mapping[str, Any]) -> Iterator[Dict[str, Any]]:
    words = [t["word"] for t in caption["tokens_info"]]
    index = 0
    while index < len(words):
        start = index
        tags = _word_pos(caption, index)
        if "DET" in tags:
            index += 1
        while index < len(words) and "ADJ" in _word_pos(caption, index) \
                and not {"NOUN", "PROPN"} & _word_pos(caption, index):
            index += 1
        noun_start = index
        while index < len(words):
            tags = _word_pos(caption, index)
            if not {"NOUN", "PROPN"} & tags \
                    or tags & {"DET", "ADP", "PRON", "AUX", "CCONJ", "SCONJ",
                               "PART"}:
                break
            # A VERB-candidate after the first noun ends the chunk ("the cat
            # sits" — "sits" is NOUN|VERB-ambiguous, but a noun precedes it).
            if "VERB" in tags and index > noun_start:
                break
            index += 1
        if index > noun_start:
            span = _span(caption, start, index)
            span["text"] = f"A photo of {span['text']}."
            yield span
        else:
            index = start + 1


def _is_verb_anchor(caption: Mapping[str, Any], index: int) -> bool:
    tags = _word_pos(caption, index)
    return "VERB" in tags and "AUX" not in tags


def get_verb_phrases(caption: Mapping[str, Any]) -> Iterator[Dict[str, Any]]:
    total = len(caption["tokens_info"])
    for index in range(total):
        if _is_verb_anchor(caption, index):
            end = index + 1
            while end < total and not _is_verb_anchor(caption, end):
                end += 1
            yield _span(caption, index, end)


def get_orders(caption: Mapping[str, Any]) -> Iterator[Dict[str, Any]]:
    for sentence in get_sents(caption):
        if sentence["text"].endswith("?"):
            continue
        first = sentence["text"].split()[0]
        tags = _plausible_pos(first)
        if "VERB" in tags and "AUX" not in tags \
                and first.lower() not in _ORDER_STOPLIST \
                and not first.lower().endswith(("ing", "ed")):
            yield sentence

# %% [markdown]
# ## Batch figure export (reference cell 23: `show_caption_figures_and_pdf`)

# %%
_SPAN_MINERS = {
    "sents": get_sents,
    "nouns": get_noun_chunks,
    "verb_phrases": get_verb_phrases,
    "orders": get_orders,
}


def show_caption_figures_and_pdf(video_id: str, caption: Mapping[str, Any],
                                 encoded_frames: np.ndarray, encoder,
                                 times: Sequence[float],
                                 thumbnail_times: Sequence[float],
                                 thumbnails: Sequence[np.ndarray],
                                 text_mode: str = "sents",
                                 output_dir: str = ".") -> Optional[str]:
    spans = list(_SPAN_MINERS[text_mode](caption))
    if not spans:
        return None
    pdf_path = os.path.join(output_dir, f"{video_id}_{text_mode}.pdf")
    with PdfPages(pdf_path) as pdf_pages:
        for span in spans:
            figure = create_figure_for_text(
                encoded_frames, span["text"], encoder, times,
                thumbnail_times, thumbnails)
            pdf_pages.savefig(figure, bbox_inches="tight")
            plt.close(figure)
    return pdf_path

# %% [markdown]
# ## Driver
#
# Point `VIZ_VIDEOS_DIR` / `VIZ_CAPTIONS_DIR` at the demo corpus (the
# reference's cells 60–65 sample `demo/static/videos/`), pick an encoder via
# `VIZ_CHECKPOINT` (OpenAI/HF CLIP state dict) or fall back to the tiny
# random encoder so the notebook always runs end to end.

# %%
def load_encoder():
    from fitclip_tpu.models.clip.load import (load_clip_encoder,
                                              load_tiny_test_encoder)

    checkpoint = os.environ.get("VIZ_CHECKPOINT")
    if checkpoint:
        return load_clip_encoder("ViT-B/16", checkpoint_path=checkpoint)
    # No weights around: tiny random encoder + a synthesized vocab so the
    # notebook still runs end to end (curves are then structure, not meaning).
    import tempfile

    from fitclip_tpu.models.clip.tokenizer import write_tiny_test_vocab

    vocab_dir = tempfile.mkdtemp(prefix="viz_vocab_")
    merges, vocab = write_tiny_test_vocab(
        vocab_dir, "a photo of the cat dog liquid container pour run".split())
    return load_tiny_test_encoder(bpe_path=merges, vocab_path=vocab)


def main(sample_size: int = 4, seed: int = 0) -> List[str]:
    import random

    videos_dir = os.environ.get("VIZ_VIDEOS_DIR", "demo/static/videos")
    captions_dir = os.environ.get("VIZ_CAPTIONS_DIR", "demo/static/captions")
    output_dir = os.environ.get("VIZ_OUTPUT_DIR", ".")

    encoder = load_encoder()
    video_paths = sorted(
        entry.path for entry in os.scandir(videos_dir)
        if entry.is_file() and entry.name.endswith((".mp4", ".webm", ".avi")))
    random.Random(seed).shuffle(video_paths)

    pdf_paths = []
    for path in video_paths[:sample_size]:
        info = get_video_info(path)
        caption_path = os.path.join(captions_dir, f"{info['video_id']}.json")
        if not os.path.exists(caption_path):
            continue
        caption = load_caption(caption_path)
        if not caption:
            continue
        encoded_frames = encode_visual(info["frames"], encoder)
        for text_mode in ("sents", "orders"):
            pdf_path = show_caption_figures_and_pdf(
                info["video_id"], caption, encoded_frames, encoder,
                info["frame_times"], info["thumbnail_times"],
                info["thumbnails"], text_mode=text_mode,
                output_dir=output_dir)
            if pdf_path:
                pdf_paths.append(pdf_path)
    return pdf_paths


# %%
if __name__ == "__main__":
    for produced in main():
        print(produced)
