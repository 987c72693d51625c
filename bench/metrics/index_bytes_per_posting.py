"""host index and device images: at the window's end the host dynamic
indexes' ``total_bytes()`` (vocabulary hash included) plus the resident
device images' bytes, over the postings held: what a deployment of the
in-memory index pays, the paper's second claim."""


def read(run):
    fp = run.footprint
    if not fp.get("postings"):
        return None
    return (fp["host_bytes"] + fp["image_bytes"]) / fp["postings"]
