"""host index layer: host-clock time in the service's ingest calls
(``QueryService.ingest_batch``) and the writer queues' drains
(``IngestPipeline.drain``) over the documents ingested in the window,
ms/doc."""


def read(run):
    if not run.docs_ingested:
        return None
    s = sum(x.seconds for x in run.spans
            if x.name in ("QueryService.ingest_batch",
                          "IngestPipeline.drain"))
    return s / run.docs_ingested * 1e3
