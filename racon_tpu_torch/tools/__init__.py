"""Operator tools over what the serve layer leaves behind, each run as
`python -m racon_tpu_torch.tools.<name>` and taking flags only:

    obsreport     a journal's job timelines beside the flight dumps, and
                  the journal checks (`--check`)
    tracereport   a merged trace's critical path split into stages (plan,
                  requeue, hold, wait, queue, device, host, gather, net,
                  merge), and its self-checks (`--check`)
    servetop      a live console over servers and routers: the fleet
                  line, a row a replica, tenants, the winner table, the
                  window cache, the audit and the autoscaler
"""
