"""Traffic: each mix is a data file ``<traffic>.json`` whose ``kind`` names
the module ``<kind>.py`` that runs it (``rollout``: closed-loop batched
stepping; ``mpc``: receding-horizon planning)."""
