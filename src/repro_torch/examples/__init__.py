"""The reference's example scripts on the port's modules, each runnable as
``python -m repro_torch.examples.<name>`` (``--device cpu`` runs the plain
PyTorch paths on a machine without a GPU):

* ``quickstart``: the controller plans, places, scales and fails over the
  IPsec Gateway; the replicated data plane equals the single-pipeline
  oracle;
* ``nic_apps``: the six applications on the data plane, each against its
  oracle, with their throughput on this device;
* ``serve_pipeline``: the Meili-planned LM server on a reduced config;
* ``serve_tenants``: the six-tenant service under diurnal traffic with an
  injected NIC failure, its per-tick table, events and SLO report;
* ``train_lm``: a ~100M-parameter LM trained to a simulated crash and
  resumed from its last checkpoint.
"""
