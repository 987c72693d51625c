"""device images layer: the bytes of every distinct device storage the
resident frozen and delta images hold at the window's end, over the
postings the host indexes hold."""


def read(run):
    fp = run.footprint
    if not fp.get("postings"):
        return None
    return fp["image_bytes"] / fp["postings"]
