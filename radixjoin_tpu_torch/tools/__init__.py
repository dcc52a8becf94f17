"""The in-kernel gather experiments on the card (counterparts of the JAX
package's ``tools/expt_pallas.py``, ``tools/expt_primitives.py`` and
``tools/expt_gather2.py``): can a gather from a table held on chip beat a
gather from device memory? Run each as a module, for example
``python -m radixjoin_tpu_torch.tools.expt_pallas``. Beside them,
``multihost_worker`` is one rank of a distributed-join cluster (the JAX
package's ``tools/multihost_worker.py``)."""
