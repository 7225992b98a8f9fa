package jepsen.tpu.hazelcast;

import com.hazelcast.core.EntryView;
import com.hazelcast.map.merge.MapMergePolicy;
import com.hazelcast.nio.ObjectDataInput;
import com.hazelcast.nio.ObjectDataOutput;
import com.hazelcast.nio.serialization.DataSerializable;

import java.io.IOException;
import java.util.SortedSet;
import java.util.TreeSet;

/**
 * Split-brain merge policy for the hazelcast suite's CRDT-style set
 * workload: when partitions heal, reconcile the two replicas of a
 * long[]-encoded set by taking their union, so no acknowledged add is
 * dropped by the merge (the anomaly the default policies exhibit and
 * the set checker exists to catch). Installed on the server classpath
 * by the suite's DB setup; counterpart of the server extension the
 * reference ships with its hazelcast suite.
 */
public class SetUnionMergePolicy implements MapMergePolicy, DataSerializable {

  private static long[] values(EntryView view) {
    Object v = view == null ? null : view.getValue();
    return v == null ? new long[0] : (long[]) v;
  }

  @Override
  public Object merge(String mapName, EntryView merging, EntryView existing) {
    SortedSet<Long> union = new TreeSet<Long>();
    for (long x : values(merging)) {
      union.add(x);
    }
    for (long x : values(existing)) {
      union.add(x);
    }
    long[] out = new long[union.size()];
    int i = 0;
    for (long x : union) {
      out[i++] = x;
    }
    return out;
  }

  @Override
  public void writeData(ObjectDataOutput out) throws IOException {
    // stateless: nothing to serialize
  }

  @Override
  public void readData(ObjectDataInput in) throws IOException {
    // stateless: nothing to deserialize
  }
}
