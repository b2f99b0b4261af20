"""Host-side multimodal rope (mrope) position computation for Qwen2.5-VL.

A copy of the JAX package's ``models/mrope.py`` (plain numpy, so the port
keeps its own). Produces the [3, P] (t, h, w) position rows the language
model's ``mrope_cos_sin`` consumes, matching HF's ``get_rope_index``:
text tokens advance all three rows together; each image's merged tokens get
a constant t, row-index h, and column-index w, all offset to start right
after the preceding text; text after an image resumes at max(position) + 1.

``delta`` is ``max(position) + 1 - P``: a decode step at sequence index i
uses 1D position ``i + delta`` (all three mrope rows equal ⇒ identical to
standard rope, so the decode path needs only the scalar offset).

Tiny integer work — plain numpy, computed once per request.
"""

from __future__ import annotations

import numpy as np


def mrope_positions(
    input_ids: np.ndarray | list[int],  # [P]
    image_grid_thw: np.ndarray | None,  # [n_images, 3]
    image_token_id: int,
    spatial_merge_size: int = 2,
    tokens_per_second: int = 4,
    video: bool = False,
) -> tuple[np.ndarray, int]:
    ids = np.asarray(input_ids, np.int64)
    P = ids.shape[0]
    if image_grid_thw is None or len(np.atleast_2d(image_grid_thw)) == 0:
        pos = np.broadcast_to(np.arange(P, dtype=np.int32), (3, P)).copy()
        return pos, 0

    grids = np.atleast_2d(np.asarray(image_grid_thw, np.int64))
    pos = np.zeros((3, P), np.int32)
    st = 0  # token cursor
    next_pos = 0  # next position index
    for t, h, w in grids:
        gh, gw = int(h) // spatial_merge_size, int(w) // spatial_merge_size
        n_vis = int(t) * gh * gw
        # locate this image's placeholder run
        rest = ids[st:]
        hits = np.nonzero(rest == image_token_id)[0]
        if hits.size == 0:
            raise ValueError(
                f"{n_vis} visual tokens expected but no image placeholder "
                f"found after index {st}"
            )
        ed = st + int(hits[0])
        text_len = ed - st
        pos[:, st:ed] = next_pos + np.arange(text_len, dtype=np.int32)
        next_pos += text_len
        t_idx = np.repeat(
            np.arange(int(t), dtype=np.int32) * (tokens_per_second if video else 0),
            gh * gw,
        )
        h_idx = np.tile(np.repeat(np.arange(gh, dtype=np.int32), gw), int(t))
        w_idx = np.tile(np.tile(np.arange(gw, dtype=np.int32), gh), int(t))
        pos[0, ed : ed + n_vis] = next_pos + t_idx
        pos[1, ed : ed + n_vis] = next_pos + h_idx
        pos[2, ed : ed + n_vis] = next_pos + w_idx
        next_pos = int(pos[:, ed : ed + n_vis].max()) + 1
        st = ed + n_vis
    if st < P:
        pos[:, st:] = next_pos + np.arange(P - st, dtype=np.int32)
        next_pos += P - st
    return pos, int(pos.max()) + 1 - P
