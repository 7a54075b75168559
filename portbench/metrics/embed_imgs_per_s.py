"""embed_imgs_per_s: images whose embeddings and stats reached the store and
the sidecars in the window's whole passes, over the seconds of those passes."""


def read(run):
    w = run.window
    return w["images"] / w["seconds"] if w.get("images") else None
