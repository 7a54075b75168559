"""All pairs above a cosine threshold, plainly: rows normalized in float32,
every block of the upper triangle a float32 product with TF32 off, and every
pair (i < j) whose cosine is above the threshold kept with it. ``control``
rounds the normalized rows to TF32 first (one step below float32), as the
tensor cores would with TF32 on, on any device."""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import round_to_tf32, tf32


def pairs_above(rows: torch.Tensor, threshold: float, block: int = 8192,
                control: bool = False) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(i, j, cosine) of every pair i < j with cosine > ``threshold``, sorted by
    (i, j). ``rows``: [N, D] float32 on the device that computes."""
    x = rows / torch.linalg.vector_norm(rows, dim=-1, keepdim=True)
    if control:
        x = round_to_tf32(x)
    n = len(x)
    found_i, found_j, found_c = [], [], []
    with tf32(False), torch.inference_mode():
        for r0 in range(0, n, block):
            a = x[r0:r0 + block]
            for c0 in range(r0, n, block):
                sim = a @ x[c0:c0 + block].t()
                above = sim > threshold
                if c0 == r0:
                    above = torch.triu(above, diagonal=1)
                ii, jj = above.nonzero(as_tuple=True)
                found_i.append(ii + r0)
                found_j.append(jj + c0)
                found_c.append(sim[ii, jj])
    i = torch.cat(found_i).cpu().numpy().astype(np.int64)
    j = torch.cat(found_j).cpu().numpy().astype(np.int64)
    c = torch.cat(found_c).cpu().numpy()
    order = np.lexsort((j, i))
    return i[order], j[order], c[order]
