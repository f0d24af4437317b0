"""1 - seconds inside MatchService.match / match_many over client-seen
seconds: HTTP, JSON and base64."""

from portbench.measure import daemon_share


def read(rec):
    return daemon_share(rec)
